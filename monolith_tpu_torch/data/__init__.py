from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.data.example import (Example, LineId, batch_examples,
                                             make_fid_v1, make_fid_v2)
from monolith_tpu_torch.data.framing import (RecordReader, RecordWriter,
                                             read_example_file,
                                             write_example_file)
from monolith_tpu_torch.data.datasets import (BatchedDataset, FileSource,
                                              KafkaSource, ParquetSource,
                                              QueueSource, merge_flow,
                                              split_flow)
from monolith_tpu_torch.data.item_pool import ItemPool, negative_gen
from monolith_tpu_torch.data import pb_compat
from monolith_tpu_torch.data.feature_list import Feature, FeatureList
from monolith_tpu_torch.data import transforms
