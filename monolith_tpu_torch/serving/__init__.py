"""Serving: model export, the serving-side inference engine and the payload
codec. (The gRPC agent, router and parameter-sync client are not ported.)"""

from monolith_tpu_torch.serving import codec
from monolith_tpu_torch.serving.engine import ServingModel
from monolith_tpu_torch.serving.export import export_model, latest_export

__all__ = ["ServingModel", "codec", "export_model", "latest_export"]
