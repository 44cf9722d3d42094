"""Per-party checkpoint / resume for federated training state.

Each party snapshots its local state (params, server-optimizer state, the
round counter, any pytree) under its own directory; on restart the parties
restore the latest common round and the deterministic seq-id contract
takes care of the rest (all parties re-enter the same rendezvous
sequence).

The snapshot is the JAX package's ``use_orbax=False`` form: ``state.npz``
holds the leaves as ``leaf_{i}`` in flatten order (JAX's rules, which
:mod:`rayfed_tpu_torch.tree_util` follows), beside a ``meta.json``.  A
snapshot written by either package restores in the other.  Orbax imports
JAX, so this package never uses it: ``use_orbax=True`` raises, as the JAX
package does where orbax is missing.

A bfloat16 (or float8) leaf is stored as numpy stores such a dtype, as
void bytes of its width (``|V2``), with or without ``ml_dtypes``; restore
views a void leaf as its target leaf's dtype, bit for bit.  Restored
leaves are torch tensors on the party's card (``device=``, else the
runtime transport's device, else the current CUDA card); they go on the
CPU only when asked (``FedCheckpointer(..., device="cpu")``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import telemetry, tree_util

logger = logging.getLogger(__name__)

# Leaf dtypes numpy knows only through ml_dtypes: stored as void bytes.
_VOID_DTYPES = frozenset(
    d for d in (
        torch.bfloat16,
        getattr(torch, "float8_e4m3fn", None),
        getattr(torch, "float8_e5m2", None),
    ) if d is not None
)


def _npz_leaf(leaf: Any) -> Any:
    """One leaf as ``np.savez`` writes it in the JAX package's file."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().cpu().contiguous()
        if host.dtype in _VOID_DTYPES:
            raw = host.reshape(-1).view(torch.uint8).numpy()
            return raw.view(np.dtype(f"V{host.element_size()}")).reshape(tuple(host.shape))
        return host.numpy()
    if isinstance(leaf, np.ndarray) and not leaf.dtype.isbuiltin and leaf.dtype.kind != "V":
        # An ml_dtypes array (bfloat16, float8): numpy writes its bytes as
        # void of its width.
        return np.ascontiguousarray(leaf).view(np.dtype(f"V{leaf.dtype.itemsize}"))
    return leaf


def _place(arr: Any, like: Any, device: torch.device) -> Any:
    """A stored leaf as a tensor on ``device``: a void leaf viewed as its
    target leaf's dtype; any other keeps its stored dtype, as the JAX
    package's restore does."""
    if not isinstance(arr, np.ndarray) or arr.dtype.kind in "OUS":
        return arr
    if arr.dtype.kind == "V":
        dtype = like.dtype if isinstance(like, torch.Tensor) else None
        if dtype is None or torch.empty((), dtype=dtype).element_size() != arr.dtype.itemsize:
            raise ValueError(
                f"stored leaf is {arr.dtype.itemsize}-byte void data and its "
                f"target leaf ({getattr(like, 'dtype', type(like).__name__)}) "
                f"does not name a dtype of that width to view it as"
            )
        raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy())
        return raw.view(dtype).reshape(arr.shape).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)  # a 0-d leaf stays 0-d


class FedCheckpointer:
    """Round-indexed checkpoints for one party.

    Layout: ``{directory}/{party}/round_{n:08d}/`` with ``state.npz`` and
    ``meta.json``.  ``device``: where restored leaves go (see the module
    docstring).
    """

    def __init__(
        self,
        directory: str,
        party: str,
        *,
        max_to_keep: int = 3,
        use_orbax: Optional[bool] = None,
        object_plane: Any = None,
        device: Any = None,
    ) -> None:
        if use_orbax:
            raise RuntimeError(
                "orbax requested but not importable (it imports JAX); "
                "use_orbax=False writes the npz snapshot both packages read"
            )
        self._dir = os.path.join(os.path.abspath(directory), party)
        os.makedirs(self._dir, exist_ok=True)
        self._party = party
        self._max_to_keep = max_to_keep
        # Content-addressed fast path (transport/objectstore.py): save
        # stamps each snapshot's wire-bytes fingerprint into meta.json
        # and publishes the bytes into the party's object plane; restore
        # resolves the fingerprint against the content cache before
        # touching disk.  An explicit object_plane= overrides the runtime
        # discovery (tests and standalone tooling).
        self._object_plane = object_plane
        self._device = device

    def _plane(self):
        if self._object_plane is not None:
            return self._object_plane
        transport = self._transport()
        return getattr(transport, "objects", None)

    @staticmethod
    def _transport():
        from rayfed_tpu_torch.runtime import get_runtime_or_none

        runtime = get_runtime_or_none()
        return getattr(runtime, "transport", None) if runtime else None

    def _resolve_device(self) -> torch.device:
        device = self._device
        if device is None:
            device = getattr(self._transport(), "device", None)
        from rayfed_tpu_torch.utils.platform import resolve_device

        return resolve_device(device)

    # -- paths ---------------------------------------------------------------

    def _round_dir(self, round_num: int) -> str:
        return os.path.join(self._dir, f"round_{round_num:08d}")

    def _recover(self) -> None:
        """Finish an interrupted save: a ``round_N.old`` left behind by a
        crash is promoted back to ``round_N`` if the canonical dir is
        missing, or deleted if the canonical dir completed."""
        for name in os.listdir(self._dir):
            m = re.fullmatch(r"(round_\d+)\.old", name)
            if not m:
                continue
            old_path = os.path.join(self._dir, name)
            canonical = os.path.join(self._dir, m.group(1))
            if os.path.exists(os.path.join(canonical, "meta.json")):
                shutil.rmtree(old_path)
            else:
                if os.path.exists(canonical):
                    shutil.rmtree(canonical)  # incomplete promote
                os.replace(old_path, canonical)

    def rounds(self) -> list[int]:
        self._recover()
        out = []
        for name in os.listdir(self._dir):
            m = re.fullmatch(r"round_(\d+)", name)
            if m and os.path.exists(os.path.join(self._dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_round(self) -> Optional[int]:
        rounds = self.rounds()
        return rounds[-1] if rounds else None

    # -- save / restore ------------------------------------------------------

    def save(self, round_num: int, state: Any, *, metadata: Optional[dict] = None):
        """Snapshot ``state`` (any pytree) as round ``round_num``.

        Beside the on-disk snapshot, the residency-normalized state's wire
        bytes are fingerprinted (the JAX package's stamp for the same
        values) and published, unpinned, into the party's object plane
        when one is available; ``meta.json`` carries the stamp so
        :meth:`restore` can resolve the snapshot by content first."""
        t0_wall, t0 = time.time(), time.perf_counter()
        blob_stamp: dict = {}
        plane = self._plane()
        if plane is not None:
            try:
                from rayfed_tpu_torch import objects as _objects

                fp, data = _objects.fingerprint_value(_objects.canonical_host(state))
                # Unpinned: the cached snapshot is a warm-restore
                # optimization with a durable disk fallback; it must never
                # consume budget the live round state needs.
                plane.publish(data=data)
                blob_stamp = {"blob_fp": fp, "blob_n": len(data)}
            except Exception:  # the plane must not break the disk path
                logger.exception(
                    "[%s] checkpoint blob publish failed; disk snapshot "
                    "proceeds without a fingerprint stamp", self._party,
                )
        path = self._round_dir(round_num)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        leaves, _treedef = tree_util.tree_flatten(state)
        np.savez(
            os.path.join(tmp, "state.npz"),
            **{f"leaf_{i}": _npz_leaf(leaf) for i, leaf in enumerate(leaves)},
        )
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(
                {"round": round_num, "party": self._party, **blob_stamp,
                 **(metadata or {})}, f
            )
        # A complete checkpoint stays under some name at every instant:
        # move the old round aside, promote the new one, drop the old copy.
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()
        telemetry.emit(
            "ckpt.save", party=self._party, round=round_num,
            t_start=t0_wall, dur_s=time.perf_counter() - t0,
            nbytes=int(blob_stamp.get("blob_n", 0)),
            detail=blob_stamp or None,
        )
        logger.info("[%s] checkpoint saved: round %d", self._party, round_num)

    def restore(
        self, round_num: Optional[int] = None, *, target: Any = None
    ) -> Tuple[int, Any]:
        """Restore ``(round, state)``; ``round_num=None`` means the latest.

        ``target``: an example pytree giving the structure and the dtypes
        of void leaves (required for a disk restore)."""
        self._recover()
        if round_num is None:
            round_num = self.latest_round()
            if round_num is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        dev = self._resolve_device()
        t0_wall, t0 = time.time(), time.perf_counter()
        cached = self._restore_from_blob(round_num, target, dev)
        if cached is not None:
            telemetry.emit(
                "ckpt.restore", party=self._party, round=round_num,
                t_start=t0_wall, dur_s=time.perf_counter() - t0,
                detail={"source": "blob"},
            )
            return round_num, cached
        path = self._round_dir(round_num)
        npz = os.path.join(path, "state.npz")
        if not os.path.exists(npz) and os.path.isdir(os.path.join(path, "state")):
            raise ValueError(
                f"{path} holds an orbax snapshot (state/), which this "
                f"package cannot read; write checkpoints with "
                f"FedCheckpointer(use_orbax=False) to share them"
            )
        if target is None:
            raise ValueError("npz restore requires target=")
        t_leaves, t_def = tree_util.tree_flatten(target)
        with np.load(npz) as data:
            leaves = [_place(data[f"leaf_{i}"], like, dev) for i, like in enumerate(t_leaves)]
        state = tree_util.tree_unflatten(leaves, t_def)
        telemetry.emit(
            "ckpt.restore", party=self._party, round=round_num,
            t_start=t0_wall, dur_s=time.perf_counter() - t0,
            detail={"source": "disk"},
        )
        return round_num, state

    def _restore_from_blob(self, round_num: int, target: Any, dev: torch.device) -> Optional[Any]:
        """The state for ``round_num`` decoded from the object plane's
        content cache (the saved container structure, leaves placed as a
        disk restore places them), or ``None`` on any miss."""
        plane = self._plane()
        if plane is None:
            return None
        try:
            meta_path = os.path.join(self._round_dir(round_num), "meta.json")
            with open(meta_path) as f:
                fp = json.load(f).get("blob_fp")
        except OSError:
            return None
        if not fp:
            return None
        data = plane.fetch_local_bytes(fp)
        if data is None:
            return None
        try:
            from rayfed_tpu_torch import objects as _objects

            state = _objects.deserialize_blob(data)
            leaves, s_def = tree_util.tree_flatten(state)
            likes = tree_util.tree_leaves(target) if target is not None else [None] * len(leaves)
            if len(likes) != len(leaves):
                likes = [None] * len(leaves)
            state = tree_util.tree_unflatten(
                [_place(_npz_leaf(x), like, dev) for x, like in zip(leaves, likes)], s_def
            )
        except Exception:  # a corrupt cache entry falls back to disk
            logger.exception(
                "[%s] checkpoint blob %s failed to decode; falling back to "
                "the disk snapshot", self._party, fp,
            )
            return None
        logger.info(
            "[%s] checkpoint round %d restored from the content cache (%s)",
            self._party, round_num, fp,
        )
        return state

    def load_metadata(self, round_num: Optional[int] = None) -> dict:
        """The ``meta.json`` of one round's snapshot (latest by default):
        the ``metadata=`` passed to :meth:`save` plus the ``round``/
        ``party`` stamps and the blob stamp."""
        self._recover()
        if round_num is None:
            round_num = self.latest_round()
            if round_num is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        with open(os.path.join(self._round_dir(round_num), "meta.json")) as f:
            return json.load(f)

    def _gc(self) -> None:
        rounds = self.rounds()
        for stale in rounds[: -self._max_to_keep]:
            shutil.rmtree(self._round_dir(stale), ignore_errors=True)
