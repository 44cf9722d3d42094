"""PyTorch/CUDA port of rayfed-tpu, grown slice by slice beside the JAX package.

The JAX package ``rayfed_tpu`` is the reference: this package mirrors its
module paths and function names so each counterpart is easy to find, and
imports neither JAX nor anything of the reference.  The federated API is
the reference's (``fed/__init__.py:15-29`` of RayFed): every party runs the
same driver program, ``@remote`` tasks and actors are pinned to a party,
and the data owner pushes results over the RFW1 v4 transport, whose bytes
a party of the JAX package reads too.  Tasks run torch code on the party's
CUDA card (``init(..., device=)``).
"""

# Lock-order sanitizer (RAYFED_SANITIZE=1): installs BEFORE the submodules
# below construct their module and instance locks, since only locks built
# after install() are tracked.  One environment read when the flag is unset.
from rayfed_tpu_torch import _sanitizer as _sanitizer

_sanitizer.maybe_install_from_env()

from rayfed_tpu_torch.api import (
    init,
    shutdown,
    remote,
    get,
    kill,
    join,
    leave,
    set_max_message_length,
    trace_collect,
    metrics_snapshot,
)
from rayfed_tpu_torch.exceptions import RemoteError
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.metrics import get_stats
from rayfed_tpu_torch.proxy import send, recv
from rayfed_tpu_torch import telemetry, tree_util

__version__ = "0.5.0"

__all__ = [
    "init",
    "shutdown",
    "remote",
    "get",
    "kill",
    "join",
    "leave",
    "send",
    "recv",
    "set_max_message_length",
    "FedObject",
    "RemoteError",
    "tree_util",
    "get_stats",
    "trace_collect",
    "metrics_snapshot",
    "telemetry",
    "__version__",
]
