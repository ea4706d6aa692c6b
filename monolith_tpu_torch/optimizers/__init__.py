from monolith_tpu_torch.optimizers.dense import (Adagrad, Adamom, RMSpropV2,
                                                 Shampoo, adamom, adamom_v2,
                                                 rmsprop_v2, shampoo)
