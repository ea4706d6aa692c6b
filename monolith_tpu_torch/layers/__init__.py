from monolith_tpu_torch.layers import activations
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.layers.cross import CIN, CrossNet, LowRankCross
from monolith_tpu_torch.layers.dense import AddBias, Dense
from monolith_tpu_torch.layers.feature_cross import (FFM, CAN, CDot, DCN,
                                                     AllInt, GroupInt)
from monolith_tpu_torch.layers.feature_trans import AutoInt, SeNet, iRazor
from monolith_tpu_torch.layers.feature_seq import DIEN, DIN, DMR_U2I
from monolith_tpu_torch.layers.agru import AGRUCell, AUGRU, GRU, GRUCell
from monolith_tpu_torch.layers.multi_task import MMoE, SNR
from monolith_tpu_torch.layers.lhuc import LHUCTower
from monolith_tpu_torch.layers.logit_correction import (LogitCorrection,
                                                        logit_correction)
from monolith_tpu_torch.layers.norms import (BatchNorm, GradNorm, LayerNorm,
                                             grad_norms_wrt)
from monolith_tpu_torch.layers.pooling import (AvgPooling, MaxPooling,
                                               SumPooling, avg_pooling,
                                               max_pooling, sum_pooling)
