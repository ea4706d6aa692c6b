from monolith_tpu_torch.losses.losses import (batch_softmax_loss,
                                              bce_with_logits,
                                              inbatch_auc_loss)
from monolith_tpu_torch.losses.ltr import (RankingLossKey, approx_ndcg_loss,
                                           list_mle_loss, make_loss_fn,
                                           mean_squared_loss,
                                           pairwise_hinge_loss,
                                           pairwise_logistic_loss,
                                           pairwise_soft_zero_one_loss,
                                           sigmoid_cross_entropy_loss,
                                           softmax_loss)
