from monolith_tpu_torch.models.deepfm import DeepFMModule, DeepFMTask
from monolith_tpu_torch.models.din import DINModule, DINTask
from monolith_tpu_torch.models.ffm import FFMModule, FFMTask
from monolith_tpu_torch.models.multitask import MMoEModule, MMoETask
from monolith_tpu_torch.models.multislot import MultiSlotModule, MultiSlotTask
from monolith_tpu_torch.models.dcn import DCNModule, DCNTask
from monolith_tpu_torch.models.dlrm_dcnv2 import (DLRMDCNv2Module,
                                                  DLRMDCNv2Task)
from monolith_tpu_torch.models.autoint import AutoIntModule, AutoIntTask
from monolith_tpu_torch.models.movie_ranking import (MovieRankingModule,
                                                      MovieRankingTask)
