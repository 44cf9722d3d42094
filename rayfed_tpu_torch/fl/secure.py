"""DEPRECATED shim: the secure-aggregation subsystem lives in
:mod:`rayfed_tpu_torch.fl.secagg`.

This module was the seed-era demo: whole-tree fixed-point masking with an
operator-provisioned group key, applied around ``fed.get``.  The real
subsystem (masking in the shared-grid integer domain, pairwise key agreement
riding the transport HELLO handshake, quorum-dropout mask recovery, wired
through ``run_fedavg_rounds(secure_agg=True)``) and the in-process
primitives this module exported live in :mod:`rayfed_tpu_torch.fl.secagg`:

- :func:`~rayfed_tpu_torch.fl.secagg.pairwise_key`
- :func:`~rayfed_tpu_torch.fl.secagg.mask_update`
- :func:`~rayfed_tpu_torch.fl.secagg.unmask_sum`

Import them from ``rayfed_tpu_torch.fl.secagg`` (or
``rayfed_tpu_torch.fl``); this shim re-exports them unchanged and will be
removed.
"""

from __future__ import annotations

import warnings

from rayfed_tpu_torch.fl.secagg import (  # noqa: F401
    mask_update,
    pairwise_key,
    unmask_sum,
)

warnings.warn(
    "rayfed_tpu_torch.fl.secure is deprecated: the secure-aggregation "
    "subsystem lives in rayfed_tpu_torch.fl.secagg (transport rounds: "
    "run_fedavg_rounds(secure_agg=True))",
    DeprecationWarning,
    stacklevel=2,
)
