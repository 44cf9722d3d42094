"""The port's native (C++) wire data plane (native/): crc32c, gather_copy and
transport integration, held against the reference's tests/test_native.py.
"""

import numpy as np
import pytest

from rayfed_tpu_torch import native


def test_crc32c_known_vectors():
    # RFC 3720 / standard CRC32-C test vector.
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    assert native._crc32c_py(b"123456789") == 0xE3069283


def test_crc32c_chaining_equals_whole():
    data = np.random.default_rng(0).integers(0, 255, 10_001, dtype=np.uint8)
    data = data.tobytes()
    whole = native.crc32c(data)
    chained = native.crc32c(data[4096:], seed=native.crc32c(data[:4096]))
    assert whole == chained
    if native.is_available():
        assert whole == native._crc32c_py(data)


def test_crc32c_large_hits_interleaved_kernel():
    """>=48KB inputs take the 6-lane GF(2)-combined fast path on the
    compiled side — must match the bitwise pure-Python reference across
    the threshold and with seed chaining (guards crc_shift_op/shift_tab
    regressions that both peers would otherwise agree on silently)."""
    rng = np.random.default_rng(7)
    for n in (49_151, 49_152, 49_153, 200_000):
        data = rng.integers(0, 255, n, dtype=np.uint8).tobytes()
        assert native.crc32c(data) == native._crc32c_py(data), n
        seed = 0x1234ABCD
        assert native.crc32c(data, seed) == native._crc32c_py(data, seed), n
    big = rng.integers(0, 255, 1 << 20, dtype=np.uint8).tobytes()
    mid = native.crc32c(big[: 300_000])
    assert native.crc32c(big) == native.crc32c(big[300_000:], seed=mid)


def test_writev_full_roundtrip():
    import socket

    a, b = socket.socketpair()
    try:
        a.setblocking(False)
        arr = np.arange(1000, dtype=np.uint16)
        n = native.writev_full(a.fileno(), [b"head", arr, b"", b"tail"])
        assert n == 4 + arr.nbytes + 4
        got = bytearray()
        while len(got) < n:
            got.extend(b.recv(65536))
        assert bytes(got) == b"head" + arr.tobytes() + b"tail"
    finally:
        a.close()
        b.close()


def test_gather_copy_and_crc():
    bufs = [b"abc", bytearray(b"defg"), np.arange(5, dtype=np.uint8)]
    expect = b"abcdefg" + bytes(range(5))
    out = native.gather_copy(bufs)
    assert bytes(out) == expect
    out2, crc = native.gather_copy(bufs, with_crc=True)
    assert bytes(out2) == expect
    assert crc == native.crc32c(expect)


def test_gather_copy_handles_views_and_dtypes():
    arr = np.arange(16, dtype=np.float32)
    out = native.gather_copy([arr, memoryview(b"xy")])
    assert bytes(out) == arr.tobytes() + b"xy"


def test_transport_checksum_end_to_end():
    """Corrupted payload must be rejected (retryable) by the server."""
    import asyncio

    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig, RetryPolicy
    from rayfed_tpu_torch.transport.manager import TransportManager

    from tests.multiproc import get_free_ports

    (port,) = get_free_ports(1)
    cluster = ClusterConfig(
        parties={"solo": PartyConfig.from_dict({"address": f"127.0.0.1:{port}"})},
        current_party="solo",
    )
    job = JobConfig(retry_policy=RetryPolicy(max_attempts=2, initial_backoff_s=0.05))
    tm = TransportManager(cluster, job)
    tm.start()
    try:
        ref = tm.recv("solo", "u1", "d1")
        assert tm.send("solo", {"x": 123}, "u1", "d1").resolve(timeout=10) is True
        assert ref.resolve(timeout=10) == {"x": 123}

        # Now forge a frame with a bad crc directly through the client.
        client = tm._get_client("solo")

        async def _bad_send():
            from rayfed_tpu_torch.transport import wire

            payload = wire.encode_payload({"x": 1})
            flat = b"".join(bytes(b) for b in payload)
            header = {"src": "solo", "up": "u2", "down": "d2", "meta": {},
                      "crc": native.crc32c(flat) ^ 0xDEADBEEF}
            try:
                await client._roundtrip(wire.MSG_DATA, header, [flat])
                return "accepted"
            except Exception as e:
                return f"rejected: {e}"

        import concurrent.futures
        fut = asyncio.run_coroutine_threadsafe(_bad_send(), tm._loop)
        result = fut.result(timeout=10)
        assert "rejected" in result and "checksum" in result, result
        assert tm._server.stats.get("receive_crc_errors", 0) == 1
    finally:
        tm.stop()
