"""Serving front end of the port: the micro-batching core and its HTTP
server (`serve/server.py`), and the exported serving bundles
(`serve/export.py`: pose, detector, bottom-up and fused programs that load
and serve without model code)."""

from probpose_pytorch_tpu_torch.serve.export import (
    BottomUpBundle,
    DetectorBundle,
    FusedBundle,
    ServingBundle,
    export_bottomup_bundle,
    export_detector_bundle,
    export_fused_bundle,
    export_predictor_bundle,
)
from probpose_pytorch_tpu_torch.serve.server import MicroBatcher, PoseHTTPServer

__all__ = [
    "BottomUpBundle",
    "DetectorBundle",
    "FusedBundle",
    "MicroBatcher",
    "PoseHTTPServer",
    "ServingBundle",
    "export_bottomup_bundle",
    "export_detector_bundle",
    "export_fused_bundle",
    "export_predictor_bundle",
]
