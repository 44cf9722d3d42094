"""The port's wire codec against the JAX package's (CPU).

Tolerance everywhere: byte identity.  The same pytree — ``np.ndarray``
leaves in both packages, a CPU ``torch.Tensor`` in the port where the
reference holds a ``jax.Array`` of the same bytes — must encode to the
same payload bytes, and each package must decode the other's payloads to
equal values.  Inputs are made from a seeded numpy generator.
"""

import collections
import ctypes
import importlib.util
import json
import pickle
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.transport import wire as jwire
from rayfed_tpu_torch.transport import wire

Point = collections.namedtuple("Point", ["x", "y"])
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("check_wire_format", ROOT / "tool" / "check_wire_format.py")
check_wire_format = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_wire_format)

MIB8 = (2048, 1024)  # float32: exactly SHARD_STREAM_THRESHOLD bytes


class CustomThing:
    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return isinstance(other, CustomThing) and other.v == self.v


def _np(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _pair(x):
    """(port tensor, reference jax.Array) holding the bytes of numpy ``x``."""
    t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16) if x.dtype == ml_dtypes.bfloat16 \
        else torch.from_numpy(x)
    return t, jnp.asarray(x)


def _cases():
    f32 = _np((3, 5), np.float32)
    bf16 = _np((4, 6), np.float32).astype(ml_dtypes.bfloat16)
    i8 = _np((7,), np.int8)
    i32 = _np((2, 3, 4), np.int32)
    big = _np(MIB8, np.float32)
    t_f32, j_f32 = _pair(f32)
    t_bf16, j_bf16 = _pair(bf16)
    t_i8, j_i8 = _pair(i8)
    t_i32, j_i32 = _pair(i32)
    t_big, j_big = _pair(big)
    nc = _np((4, 6), np.float32)
    return {
        "f32": ({"w": t_f32}, {"w": j_f32}, {}),
        "bf16": ([t_bf16, 1], [j_bf16, 1], {}),
        "int8": ((t_i8,), (j_i8,), {}),
        "int32": ({"b": t_i32, "a": None}, {"b": j_i32, "a": None}, {}),
        "zero_d": ({"s": t_f32[1, 2], "h": t_bf16[0, 0]}, {"s": j_f32[1, 2], "h": j_bf16[0, 0]}, {}),
        "noncontiguous_view": ([torch.from_numpy(nc).T], [jnp.asarray(nc.T)], {}),
        "lazy_8mib": ({"big": t_big, "small": t_i8}, {"big": j_big, "small": j_i8}, {"lazy_shards": True}),
        "8mib_eager": ({"big": t_big}, {"big": j_big}, {}),
        "numpy_leaves": ({"n": f32, "m": bf16, "z": np.array(5.0)},) * 2 + ({},),
        "python_scalars": ({"a": [1, 2.5, "s", None, True], "b": (3, {"c": 4})},) * 2 + ({},),
        "none": (None, None, {}),
        "pickled_object": ({"thing": CustomThing(7), "arr": np.ones(3)},) * 2 + ({},),
        "namedtuple": (Point(t_f32, "x"), Point(j_f32, "x"), {}),
        "object_array": ({"o": np.array([1, "a"], dtype=object)},) * 2 + ({},),
    }


CASES = _cases()


def _bytes(bufs):
    return b"".join(
        bytes(b.produce()) if isinstance(b, (wire.LazyBuffer, jwire.LazyBuffer)) else bytes(b)
        for b in bufs
    )


def _payload(mod, obj, **kw):
    return _bytes(mod.encode_payload(obj, **kw))


def _assert_same(port_value, ref_value):
    """Equal leaves, structure and dtype; tensors against arrays by bytes."""
    pl, pd = jax.tree_util.tree_flatten(port_value)
    rl, rd = jax.tree_util.tree_flatten(ref_value)
    assert pd == rd
    for a, b in zip(pl, rl):
        if isinstance(a, torch.Tensor) or isinstance(b, (jax.Array, np.ndarray)):
            a_np = wire.tensor_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            b_np = np.asarray(b)
            assert a_np.dtype == b_np.dtype and a_np.shape == b_np.shape
            assert a_np.tobytes() == b_np.tobytes()
        else:
            assert a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_bytes_identical_to_reference(name):
    port_obj, ref_obj, kw = CASES[name]
    assert _payload(wire, port_obj, **kw) == _payload(jwire, ref_obj, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_payload_decodes_in_port(name):
    port_obj, ref_obj, kw = CASES[name]
    out = wire.decode_payload(_payload(jwire, ref_obj, **kw))
    _assert_same(out, ref_obj)
    for leaf in jax.tree_util.tree_leaves(out):  # device arrays arrive as tensors
        assert not isinstance(leaf, jax.Array)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_payload_decodes_in_reference(name):
    port_obj, ref_obj, kw = CASES[name]
    out = jwire.decode_payload(_payload(wire, port_obj, **kw))
    _assert_same(port_obj, out)


def test_lazy_leaf_takes_the_nds_path():
    port_obj, _, kw = CASES["lazy_8mib"]
    bufs = wire.encode_payload(port_obj, **kw)
    (mlen,) = struct.unpack(">I", bufs[0])
    manifest = json.loads(bytes(bufs[1]))
    assert mlen == len(bufs[1])
    assert [leaf["k"] for leaf in manifest["leaves"]] == ["nds", "nd"]
    assert manifest["leaves"][0]["spec"] is None
    assert sum(isinstance(b, wire.LazyBuffer) for b in bufs) == 1
    assert not any(isinstance(b, wire.LazyBuffer) for b in wire.encode_payload(port_obj))


def test_jax_sharded_payload_decodes_by_host_assembly():
    """A 2-device-sharded jax.Array (spec not null) decodes in the port."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    x = _np(MIB8, np.float32)
    for spec in (P("dp", None), P(None, "dp")):  # rows tile axis 0; columns do not
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        payload = _payload(jwire, {"w": xs}, lazy_shards=True)
        manifest = json.loads(payload[4 : 4 + struct.unpack(">I", payload[:4])[0]])
        assert manifest["leaves"][0]["spec"] is not None
        for kw in ({}, {"device_put": True, "device": "cpu"}):
            out = wire.decode_payload(payload, **kw)["w"]
            assert isinstance(out, torch.Tensor)
            assert out.numpy().tobytes() == x.tobytes()
    # A party mesh without the sender's 2-way dp axis: the layout does not
    # resolve and the leaf decodes by host assembly as above.
    with _one_rank_world() as dmesh:
        assert wire.resolve_sharding(manifest["leaves"][0]["spec"], dmesh) is None
        out = wire.decode_payload(payload, device_put=True, device="cpu", mesh=dmesh)["w"]
        assert type(out) is torch.Tensor and out.numpy().tobytes() == x.tobytes()


class _one_rank_world:
    """A gloo world of this process alone and its ``{"dp": 1}`` DeviceMesh,
    torn down on exit."""

    def __enter__(self):
        from rayfed_tpu_torch.parallel.mesh import create_mesh
        import torch.distributed as dist

        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        return create_mesh({"dp": 1}, device="cpu")

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


@pytest.mark.parametrize("spec", [("dp", None), (None, "dp"), (None, None), (("dp",), None)],
                         ids=["rows", "columns", "replicated", "tuple"])
def test_dtensor_encodes_as_the_reference_array(spec):
    """A DTensor on a one-rank party mesh (fully addressable) encodes to the
    payload of the same layout in the JAX package: the same manifest, spec
    and axes included, and the same bytes; decoding either onto the mesh
    gives that DTensor back (each process's shard, here the whole)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    x = _np(MIB8, np.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    ref = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(*spec)))
    placement = ([Shard(spec.index("dp"))] if "dp" in spec
                 else [Shard(0)] if ("dp",) in spec else [Replicate()])
    with _one_rank_world() as mesh:
        dt = distribute_tensor(torch.from_numpy(x), mesh, placement)
        port_payload = _payload(wire, {"w": dt}, lazy_shards=True)
        ref_payload = _payload(jwire, {"w": ref}, lazy_shards=True)
        assert port_payload == ref_payload
        leaf = _manifest_of(port_payload)["leaves"][0]
        assert leaf["spec"]["axes"] == [["dp", 1]]
        for payload in (port_payload, ref_payload):
            out = wire.decode_payload(payload, device_put=True, device="cpu", mesh=mesh)["w"]
            assert isinstance(out, DTensor) and tuple(out.placements) == tuple(placement)
            assert out.to_local().numpy().tobytes() == x.tobytes()
        back = jwire.decode_payload(port_payload, device_put=True)["w"]
        assert np.asarray(back).tobytes() == x.tobytes()
        # Without lazy_shards the local tensor goes as a plain device leaf.
        assert _payload(wire, {"w": dt}) == _payload(wire, {"w": torch.from_numpy(x)})


def _manifest_of(payload):
    return json.loads(payload[4 : 4 + struct.unpack(">I", payload[:4])[0]])


def test_resolve_sharding_needs_the_sender_axes_at_their_sizes():
    from torch.distributed.tensor import Shard

    desc = {"axes": [["fsdp", 2], ["tp", 2]], "spec": [["fsdp", "tp"], None]}
    assert wire.resolve_sharding(desc, None) is None
    with _one_rank_world() as mesh:
        assert wire.resolve_sharding(desc, mesh) is None  # no fsdp axis
        assert wire.resolve_sharding({"axes": [["dp", 2]], "spec": [["dp"]]}, mesh) is None
        got = wire.resolve_sharding({"axes": [["dp", 1], ["tp", 4]], "spec": [None, ["dp"]]}, mesh)
        assert got.mesh is mesh and got.placements == (Shard(1),)
        assert wire.resolve_sharding({"axes": [["dp", 1]], "spec": [None, None]}, mesh).placements[0].is_replicate()


# -- the wire contract: constants and manifest schema --------------------------


def test_frame_constants_equal_reference():
    assert wire._HEADER_STRUCT.format == jwire._HEADER_STRUCT.format
    names = [
        "MAGIC", "HEADER_SIZE", "WIRE_FORMAT_VERSION", "MSG_DATA", "MSG_ACK",
        "MSG_PING", "MSG_PONG", "MSG_ERR", "MSG_HELLO", "FLAG_CRC_TRAILER",
        "SHARD_STREAM_THRESHOLD", "ND_ZERO_COPY_MIN_BYTES", "DELTA_CHUNK_BYTES",
        "STRIPE_MIN_BYTES", "ROUND_TAG_KEY", "EPOCH_TAG_KEY", "QUANT_GRID_KEY",
        "ASYNC_VERSION_KEY", "BLOB_GET_KEY", "BLOB_PUT_KEY", "BLOB_HANDLE_KEY",
        "TRACE_GET_KEY", "TRACE_PUT_KEY", "SECAGG_PUB_KEY", "LOCAL_HOST_KEY",
        "LOCAL_UDS_KEY", "LOCAL_TOKEN_KEY",
    ]
    for name in names:
        assert getattr(wire, name) == getattr(jwire, name), name
    frame = {"rid": 1, "up": "1#0", "meta": {"rnd": 3}}
    assert _bytes(wire.pack_frame(wire.MSG_DATA, frame, b"xyz", flags=1)) == _bytes(
        jwire.pack_frame(jwire.MSG_DATA, frame, b"xyz", flags=1)
    )
    data = bytes(range(256)) * 40000
    assert wire.blob_fingerprint(data) == jwire.blob_fingerprint(data)
    assert wire.make_delta_manifest(10, "ff", 7) == jwire.make_delta_manifest(10, "ff", 7)
    assert wire.make_stripe_marker(3, 4) == jwire.make_stripe_marker(3, 4)


def _manifest(bufs):
    return json.loads(bytes(bufs[1]))


@pytest.mark.parametrize("kind", ["nd", "nds", "pkl", "py"])
def test_manifest_schema_equals_reference(kind):
    """Per leaf kind, the manifest reduced by tool/check_wire_format.py's
    ``_schema`` (keys and value types) is the reference's."""
    x = _np(MIB8, np.float32)
    t, j = _pair(x)
    objs = {
        "nd": ({"t": t[:2], "n": x[:2]}, {"t": j[:2], "n": x[:2]}),
        "nds": ({"t": t}, {"t": j}),
        "pkl": ({"o": CustomThing(1)},) * 2,
        "py": ({"i": 1, "f": 2.0, "s": "s", "b": True, "n": None},) * 2,
    }
    port_obj, ref_obj = objs[kind]
    ours = _manifest(wire.encode_payload(port_obj, lazy_shards=True))
    theirs = _manifest(jwire.encode_payload(ref_obj, lazy_shards=True))
    assert {leaf["k"] for leaf in ours["leaves"]} == {kind}
    assert check_wire_format._schema(ours) == check_wire_format._schema(theirs)


# -- tensor specifics ---------------------------------------------------------


def test_bfloat16_decodes_without_numpy_dtype(monkeypatch):
    """A bf16 tensor leaf decodes through torch alone: numpy is never asked
    for the 'bfloat16' dtype (hosts without ml_dtypes have none)."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    payload = _payload(wire, {"t": t})
    real = np.dtype

    def strict(name, *a, **k):
        if name == "bfloat16":
            raise TypeError("data type 'bfloat16' not understood")
        return real(name, *a, **k)

    monkeypatch.setattr(np, "dtype", strict)
    out = wire.decode_payload(payload)["t"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)


def _payload_address_range(payload):
    base = ctypes.addressof(ctypes.c_char.from_buffer(payload))
    return base, base + len(payload)


def test_tensor_decode_owned_by_default_view_on_optin():
    """Device-array leaves decode as owned CPU tensors; with zero_copy,
    large ones alias a writable payload (the live receive path's
    bytearray), and a read-only payload still decodes as copies."""
    x = _np((512, 1024), np.float32)  # 2 MiB >= ND_ZERO_COPY_MIN_BYTES
    small = _np((4,), np.float32)
    payload = bytearray(_payload(wire, {"big": torch.from_numpy(x), "small": torch.from_numpy(small)}))
    lo, hi = _payload_address_range(payload)

    before = bytes(payload)
    owned = wire.decode_payload(payload)
    assert not lo <= owned["big"].data_ptr() < hi
    owned["big"][0, 0] = 42.0  # in-place consumers keep working
    assert bytes(payload) == before

    view = wire.decode_payload(payload, zero_copy=True)
    assert lo <= view["big"].data_ptr() < hi
    assert not lo <= view["small"].data_ptr() < hi  # small leaves stay copies
    assert view["big"].numpy().tobytes() == x.tobytes()

    frozen = wire.decode_payload(bytes(payload), zero_copy=True)
    assert frozen["big"].numpy().tobytes() == x.tobytes()

    on_cpu = wire.decode_payload(payload, device_put=True, device="cpu", zero_copy=True)
    assert not lo <= on_cpu["big"].data_ptr() < hi  # device_put always owns


def test_lazy_leaf_zero_copy_decode():
    x = _np(MIB8, np.float32)
    payload = bytearray(_payload(wire, torch.from_numpy(x), lazy_shards=True))
    lo, hi = _payload_address_range(payload)
    view = wire.decode_payload(payload, zero_copy=True)
    assert lo <= view.data_ptr() < hi and view.numpy().tobytes() == x.tobytes()
    owned = wire.decode_payload(payload)
    assert not lo <= owned.data_ptr() < hi and torch.equal(owned, view)


def test_device_put_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    payload = _payload(wire, {"t": torch.ones(2), "n": np.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wire.decode_payload(payload, device_put=True)
    # Nothing to place: no device is needed.
    assert wire.decode_payload(_payload(wire, [np.ones(2)]), device_put=True)[0].shape == (2,)


def test_requires_grad_and_parameter_leaves():
    p = torch.nn.Parameter(torch.arange(4.0))
    g = (torch.arange(4.0, requires_grad=True) * 2)
    out = wire.decode_payload(_payload(wire, [p, g]))
    assert torch.equal(out[0], torch.arange(4.0)) and torch.equal(out[1], torch.arange(4.0) * 2)
    assert not out[0].requires_grad


def test_unsupported_dtype_raises():
    with pytest.raises(TypeError, match="wire dtype"):
        wire.encode_payload(torch.zeros(2, dtype=torch.uint8).view(torch.float8_e4m3fnuz))


# -- ports of tests/test_wire.py ----------------------------------------------


def _roundtrip(obj, **kw):
    bufs = wire.encode_payload(obj)
    payload = b"".join(bytes(b) for b in bufs)
    return wire.decode_payload(payload, **kw)


def test_scalars_and_containers():
    obj = {"a": [1, 2.5, "s", None, True], "b": (3, {"c": 4})}
    assert _roundtrip(obj) == obj


def test_numpy_roundtrip():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = _roundtrip({"w": arr})
    np.testing.assert_array_equal(out["w"], arr)
    assert out["w"].dtype == np.float32


def test_tensor_roundtrip():
    t = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)
    out = _roundtrip([t])
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], t)


def test_tensor_device_put():
    out = _roundtrip(torch.ones(4), device_put=True, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_large_array_zero_copy_decode():
    arr = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)
    out = _roundtrip(arr)
    np.testing.assert_array_equal(out, arr)


def test_pickle_fallback_leaf():
    obj = {"thing": CustomThing(7), "arr": np.ones(3)}
    out = _roundtrip(obj)
    assert out["thing"] == CustomThing(7)


def test_allowlist_rejects_custom_class():
    obj = {"thing": CustomThing(7)}
    with pytest.raises(pickle.UnpicklingError):
        _roundtrip(obj, allowed={"numpy": "*"})


def test_allowlist_admits_numpy():
    obj = {"s": np.float64(1.5)}
    out = _roundtrip(obj, allowed={"numpy": "*"})
    assert out["s"] == np.float64(1.5)


def test_allowlist_exact_names():
    out = _roundtrip({"d": np.dtype("int32")}, allowed={"numpy": ["dtype"]})
    assert out["d"] == np.dtype("int32")


def test_allowlist_admits_the_skeleton_only_under_its_wire_name():
    """The skeleton classes pass every allowlist under the reference's
    module path; the port's own module path is not on any list."""
    out = _roundtrip({"t": torch.ones(2), "p": Point(1, 2)}, allowed={"tests": "*"})
    assert torch.equal(out["t"], torch.ones(2)) and out["p"] == Point(1, 2)
    from rayfed_tpu_torch import serialization

    forged = pickle.dumps(wire._LeafSlot(0), protocol=5)  # names the port's module
    with pytest.raises(pickle.UnpicklingError):
        serialization.loads(forged, allowed={"numpy": "*"})


def test_frame_pack_unpack():
    bufs = wire.pack_frame(wire.MSG_DATA, {"rid": 1, "up": "1#0"}, b"xyz")
    blob = b"".join(bytes(b) for b in bufs)
    msg_type, flags, hlen, plen = wire.unpack_frame_prefix(blob[: wire.HEADER_SIZE])
    assert msg_type == wire.MSG_DATA
    assert plen == 3
    with pytest.raises(ValueError):
        wire.unpack_frame_prefix(b"XXXX" + blob[4 : wire.HEADER_SIZE])


def test_scalar_and_noncontiguous_arrays_roundtrip():
    """0-d stays 0-d (np.ascontiguousarray promotes to (1,));
    non-contiguous views are copied, not corrupted."""
    cases = [
        torch.tensor(3.5),
        np.array(5.0),
        torch.ones((3, 2)).flip(0),
        torch.arange(12.0).reshape(3, 4).T,
        np.arange(12).reshape(3, 4).T,
    ]
    for x in cases:
        out = _roundtrip(x)
        assert tuple(out.shape) == tuple(x.shape), (x.shape, out.shape)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x))


def test_sharded_encode_roundtrip_host():
    """A large tensor round-trips through a lazily fetched buffer."""
    x = torch.arange(4 * 1024 * 1024, dtype=torch.float32).reshape(2048, 2048)
    bufs = wire.encode_payload({"w": x}, lazy_shards=True)
    assert any(isinstance(b, wire.LazyBuffer) for b in bufs), "expected lazy shards"
    out = wire.decode_payload(_bytes(bufs))
    assert torch.equal(out["w"], x)


def test_small_arrays_stay_eager():
    bufs = wire.encode_payload({"x": torch.ones((8, 8))}, lazy_shards=True)
    assert not any(isinstance(b, wire.LazyBuffer) for b in bufs)


def test_shared_lazy_buffer_fetches_once():
    calls = []
    x = torch.arange(float(1 << 21))

    def produce():
        calls.append(1)
        return memoryview(x.numpy()).cast("B")

    shared = wire.share_buffers([wire.LazyBuffer(produce, x.nbytes), b"x"])
    assert isinstance(shared[0], wire.SharedLazyBuffer) and shared[1] == b"x"
    assert shared[0].produce() is shared[0].produce() and len(calls) == 1
