"""The port's per-party checkpointer (``rayfed_tpu_torch/checkpoint.py``)
held against the JAX package's (``tests/test_checkpoint_metrics.py`` and the
checkpoint cases of ``tests/test_objectstore.py``), and a snapshot of either
package restored by the other: the same leaf bytes in ``state.npz``, the
same parsed ``meta.json`` and the same content fingerprint."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu_torch.checkpoint import FedCheckpointer
from rayfed_tpu_torch.fl import server_opt as t_sopt
from rayfed_tpu_torch.models.quant import QTensor, quantize_int8
from tests.test_torch_objectstore import manager_trio  # noqa: F401 (fixture)


def _ckpt(path, party, **kw):
    return FedCheckpointer(str(path), party, device="cpu", **kw)


@pytest.mark.parametrize("use_orbax", [None, False])
def test_checkpoint_save_restore(tmp_path, use_orbax):
    ckpt = _ckpt(tmp_path, "alice", use_orbax=use_orbax)
    state = {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)},
        "round": np.int64(7),
    }
    ckpt.save(3, state, metadata={"note": "test"})
    assert ckpt.latest_round() == 3
    r, restored = ckpt.restore(target=state)
    assert r == 3
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["params"]["b"], state["params"]["b"])
    assert int(restored["round"]) == 7 and restored["round"].shape == ()
    assert ckpt.load_metadata()["note"] == "test"


def test_checkpoint_gc_and_rounds(tmp_path):
    ckpt = _ckpt(tmp_path, "bob", max_to_keep=2, use_orbax=False)
    state = {"x": torch.ones(2)}
    for r in (1, 2, 3, 4):
        ckpt.save(r, state)
    assert ckpt.rounds() == [3, 4]
    r, _ = ckpt.restore(target=state)
    assert r == 4


def test_checkpoint_restore_specific_round(tmp_path):
    ckpt = _ckpt(tmp_path, "alice", use_orbax=False)
    for r in (1, 2):
        ckpt.save(r, {"x": torch.full((2,), float(r))})
    r, restored = ckpt.restore(1, target={"x": torch.zeros(2)})
    assert r == 1 and restored["x"].tolist() == [1.0, 1.0]


def test_checkpoint_int8_roundtrip(tmp_path):
    """A quantized base (QTensor leaves) restores bit-exactly."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": quantize_int8(torch.randn(8, 16, generator=gen)), "b": torch.ones(4)}
    ckpt = _ckpt(tmp_path, "alice", use_orbax=False)
    ckpt.save(1, tree)
    _, restored = ckpt.restore(target=tree)
    assert isinstance(restored["w"], QTensor)
    assert restored["w"].q.dtype == torch.int8
    assert torch.equal(restored["w"].q, tree["w"].q)
    assert torch.equal(restored["w"].scale, tree["w"].scale)


def test_checkpoint_missing_raises(tmp_path):
    ckpt = _ckpt(tmp_path, "carol", use_orbax=False)
    with pytest.raises(FileNotFoundError):
        ckpt.restore()


def test_checkpoint_orbax_refused(tmp_path):
    """``use_orbax=True`` raises as the JAX package does without orbax, and
    an orbax round directory is refused naming the npz form."""
    with pytest.raises(RuntimeError, match="orbax"):
        FedCheckpointer(str(tmp_path), "alice", use_orbax=True)
    ckpt = _ckpt(tmp_path, "alice")
    rd = ckpt._round_dir(5)
    os.makedirs(os.path.join(rd, "state"))
    with open(os.path.join(rd, "meta.json"), "w") as f:
        json.dump({"round": 5, "party": "alice"}, f)
    with pytest.raises(ValueError, match="use_orbax=False"):
        ckpt.restore(target={"x": torch.zeros(2)})


def test_checkpoint_recovers_an_interrupted_save(tmp_path):
    """A crash between moving the old round aside and promoting the new one
    leaves ``round_N.old``: it is promoted back and restores."""
    ckpt = _ckpt(tmp_path, "alice")
    ckpt.save(2, {"x": torch.full((3,), 2.0)})
    rd = ckpt._round_dir(2)
    os.replace(rd, rd + ".old")
    assert ckpt.rounds() == [2]
    _, restored = ckpt.restore(2, target={"x": torch.zeros(3)})
    assert restored["x"].tolist() == [2.0, 2.0, 2.0]
    assert not os.path.exists(rd + ".old")


def test_checkpoint_restores_onto_the_card_unless_asked(tmp_path, monkeypatch):
    """Without ``device=``, no runtime and no card, a restore raises rather
    than placing leaves on the CPU; ``device="cpu"`` places them there."""
    ckpt = FedCheckpointer(str(tmp_path), "alice")
    ckpt.save(1, {"x": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(target={"x": torch.zeros(2)})
    _, restored = _ckpt(tmp_path, "alice").restore(target={"x": torch.zeros(2)})
    assert restored["x"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Snapshots across the two packages
# ---------------------------------------------------------------------------


class _RecordingPlane:
    """An object plane holding what was published, for either package."""

    def __init__(self):
        self.blobs = {}

    def publish(self, value=None, data=None, pin=False):
        from rayfed_tpu_torch.transport import wire

        fp = wire.blob_fingerprint(bytes(data))
        self.blobs[fp] = bytes(data)
        return fp, len(data)

    def fetch_local_bytes(self, fp):
        return self.blobs.get(fp)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    bf16 = rng.standard_normal(33).astype(np.float32)
    i8 = rng.integers(-128, 128, (4, 3), dtype=np.int8)
    x = rng.standard_normal(29).astype(np.float32)
    return f32, bf16, i8, x


def _torch_state(seed=0):
    f32, bf16, i8, x = _values(seed)
    sstate = t_sopt.fedac(0.8, 6.0, 0.7).init(torch.from_numpy(x), "cpu")
    return {
        "params": {"w": torch.from_numpy(f32), "h": torch.from_numpy(bf16).to(torch.bfloat16),
                   "q": torch.from_numpy(i8)},
        "server_state": sstate,
    }


def _jax_state(seed=0):
    from rayfed_tpu.fl import server_opt as j_sopt

    f32, bf16, i8, x = _values(seed)
    sstate = j_sopt.fedac(0.8, 6.0, 0.7).init(jnp.asarray(x))
    return {
        "params": {"w": jnp.asarray(f32), "h": jnp.asarray(bf16).astype(jnp.bfloat16),
                   "q": jnp.asarray(i8)},
        "server_state": sstate,
    }


def _npz_bytes(ckpt, round_num):
    with np.load(os.path.join(ckpt._round_dir(round_num), "state.npz")) as data:
        return {k: (str(data[k].dtype), data[k].shape, data[k].tobytes()) for k in data.files}


def _meta(ckpt, round_num):
    with open(os.path.join(ckpt._round_dir(round_num), "meta.json")) as f:
        return json.load(f)


def _torch_bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


META = {"server_opt": {"kind": "fedac", "hyper": [0.8, 6.0, 0.7]}, "members": ["alice", "bob"]}


def test_snapshot_files_and_stamps_equal_the_jax_package(tmp_path):
    """The same state saved by each package: every stored leaf (dtype,
    shape, bytes; bf16 as ``|V2``), the parsed ``meta.json`` and the
    ``blob_fp`` stamp are the same."""
    from rayfed_tpu.checkpoint import FedCheckpointer as JaxCheckpointer

    j = JaxCheckpointer(str(tmp_path / "jax"), "alice", use_orbax=False, object_plane=_RecordingPlane())
    t = _ckpt(tmp_path / "torch", "alice", object_plane=_RecordingPlane())
    j.save(4, _jax_state(), metadata=META)
    t.save(4, _torch_state(), metadata=META)
    jb, tb = _npz_bytes(j, 4), _npz_bytes(t, 4)
    assert jb == tb
    assert any(dt == "|V2" for dt, _, _ in tb.values())
    assert _meta(j, 4) == _meta(t, 4)
    assert _meta(t, 4)["blob_fp"].startswith("b1.")


@pytest.mark.parametrize("cached", [False, True], ids=["disk", "blob"])
def test_jax_snapshot_restores_in_the_port(tmp_path, cached):
    from rayfed_tpu.checkpoint import FedCheckpointer as JaxCheckpointer

    plane = _RecordingPlane()
    j = JaxCheckpointer(str(tmp_path), "bob", use_orbax=False, object_plane=plane)
    j.save(2, _jax_state(1), metadata=META)
    t = _ckpt(tmp_path, "bob", object_plane=plane if cached else _RecordingPlane())
    assert t.load_metadata() == _meta(j, 2)
    r, got = t.restore(target=_torch_state(0))
    want = _leaves(_torch_state(1))
    assert r == 2 and len(_leaves(got)) == len(want)
    for a, b in zip(_leaves(got), want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device.type == "cpu"
        assert _torch_bytes(a) == _torch_bytes(b)
    assert isinstance(got["server_state"], t_sopt.PackedServerState)
    assert got["server_state"].kind == "fedac"


@pytest.mark.parametrize("cached", [False, True], ids=["disk", "blob"])
def test_port_snapshot_restores_in_the_jax_package(tmp_path, cached):
    from rayfed_tpu.checkpoint import FedCheckpointer as JaxCheckpointer
    from rayfed_tpu.fl import server_opt as j_sopt

    plane = _RecordingPlane()
    t = _ckpt(tmp_path, "carol", object_plane=plane)
    t.save(3, _torch_state(2), metadata=META)
    j = JaxCheckpointer(str(tmp_path), "carol", use_orbax=False,
                        object_plane=plane if cached else _RecordingPlane())
    assert j.load_metadata() == _meta(t, 3)
    r, got = j.restore(target=_jax_state(0))
    assert r == 3
    assert isinstance(got["server_state"], j_sopt.PackedServerState)
    import jax

    want = _leaves(_torch_state(2))
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        raw = np.asarray(a)
        if raw.dtype.kind == "V" or str(raw.dtype) == "bfloat16":
            assert b.dtype == torch.bfloat16
        assert raw.tobytes() == _torch_bytes(b)


def _leaves(tree):
    from rayfed_tpu_torch import tree_util

    return tree_util.tree_leaves(tree)


# ---------------------------------------------------------------------------
# The object plane (tests/test_objectstore.py's checkpoint cases)
# ---------------------------------------------------------------------------


class _MissPlane:
    """A plane that never hits — forces the disk path."""

    def fetch_local_bytes(self, fp):
        return None

    def publish(self, value=None, data=None, pin=False):
        return ("", 0)


def test_checkpoint_restore_via_cache_hit(tmp_path, manager_trio):  # noqa: F811
    """save() stamps the snapshot's fingerprint and publishes the bytes;
    restore() resolves by fingerprint before touching disk: with the state
    file deleted it still restores byte-identically."""
    plane = manager_trio["alice"].objects
    ckpt = _ckpt(tmp_path / "ckpt", "alice", object_plane=plane)
    state = {"params": {"w": torch.linspace(0, 1, 512)}, "round": 7}
    ckpt.save(7, state, metadata={"quorum_session": "s"})
    assert ckpt.load_metadata(7)["blob_fp"].startswith("b1.")
    disk_ckpt = _ckpt(tmp_path / "ckpt", "alice", object_plane=_MissPlane())
    target = {"params": {"w": torch.zeros(512)}, "round": 0}
    r_disk, s_disk = disk_ckpt.restore(7, target=target)
    os.remove(os.path.join(ckpt._round_dir(7), "state.npz"))
    r_hit, s_hit = ckpt.restore(7, target=target)
    assert (r_disk, r_hit) == (7, 7)
    assert torch.equal(s_hit["params"]["w"], s_disk["params"]["w"])
    assert s_hit["params"]["w"].device.type == "cpu"
    assert s_hit["round"] == 7
    with pytest.raises(FileNotFoundError):
        disk_ckpt.restore(7, target=target)


def test_checkpoint_without_plane_unchanged(tmp_path):
    """No runtime, no plane: the disk path alone, with no stamp."""
    ckpt = _ckpt(tmp_path / "c", "bob")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    ckpt.save(1, state)
    r, s = ckpt.restore(target={"w": torch.zeros(8)})
    assert r == 1 and torch.equal(s["w"], state["w"])
    assert "blob_fp" not in ckpt.load_metadata(1)


def test_blob_stamp_equals_the_jax_package_through_real_planes(tmp_path, manager_trio):  # noqa: F811
    """The stamp a port party publishes into its own plane is the JAX
    package's for the same values, whatever the state's residency."""
    from rayfed_tpu.checkpoint import FedCheckpointer as JaxCheckpointer

    t = _ckpt(tmp_path / "t", "alice", object_plane=manager_trio["alice"].objects)
    j = JaxCheckpointer(str(tmp_path / "j"), "alice", use_orbax=False, object_plane=_RecordingPlane())
    t.save(1, _torch_state(3))
    j.save(1, _jax_state(3))
    fp = _meta(t, 1)["blob_fp"]
    assert fp == _meta(j, 1)["blob_fp"]
    assert manager_trio["alice"].objects.fetch_local_bytes(fp) is not None
