"""Host-side helpers of the port."""

from rayfed_tpu_torch.utils.validation import validate_address, validate_cluster_info
from rayfed_tpu_torch.utils.logging_utils import setup_logger
from rayfed_tpu_torch.utils.platform import resolve_device

__all__ = [
    "validate_address",
    "validate_cluster_info",
    "setup_logger",
    "resolve_device",
]
