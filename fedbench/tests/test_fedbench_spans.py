"""The readers of the program's stage spans (``fedbench/spans.py``) on
hand-built contexts whose answers are known, and their silence where a run
holds no trace or a program has no such spans."""

import pytest

from fedbench import spec, spans

NEW = ("step.local_ms", "wire.transfer_ms", "agg.host_ms", "idle_unattributed")


def sp(party, phase, t, dur, peer=None, fn=None):
    return [party, None, None, phase, peer, None, 0, t, dur, "ok", {"fn": fn} if fn else None]


def ctx_of(span_rows, kernels=None, traced=True):
    return {"traced": {"t0": 10.0, "t1": 20.0, "rounds": 2} if traced else None, "platform": "gpu",
            "coordinator": "alice", "spans": span_rows, "kernels": kernels}


def read(name, ctx, kind="resnet"):
    return spec.metrics()[f"{name}.{kind}"].read(ctx)


def test_every_reader_has_both_kinds():
    m = spec.metrics()
    for name in NEW:
        assert {m[f"{name}.{k}"].KIND for k in ("llama", "resnet")} == {"llama", "resnet"}
        assert m[f"{name}.llama"].read is m[f"{name}.resnet"].read


def test_local_step_runs_to_the_card_end():
    rows = [
        sp("alice", "exec.call", 11.0, 0.5, fn="Trainer.train"),
        sp("alice", "exec.device", 11.5, 0.5, fn="Trainer.train"),  # opens at the call's end
        sp("bob", "exec.call", 12.0, 0.2, fn="Trainer.train"),  # no card work: the call's end
        sp("bob", "exec.device", 13.0, 5.0, fn="Trainer.train"),  # another call's: not paired
        sp("alice", "exec.call", 12.0, 3.0, fn="_decide"),  # not the local step
        sp("alice", "exec.call", 5.0, 1.0, fn="Trainer.train"),  # before the traced rounds
        sp("bob", "exec.call", 19.0, 0.5, fn="Trainer.train"),  # its card work runs past them
        sp("bob", "exec.device", 19.5, 1.0, fn="Trainer.train"),
        sp("alice", "trainer.train", 11.0, 9.0),  # the benchmark's own span: not read
    ]
    assert read("step.local_ms", ctx_of(rows)) == pytest.approx((1000 + 200) / 2)


def test_transfer_leaves_out_the_wait_for_the_card():
    rows = [
        sp("bob", "wire.send", 13.0, 1.0, peer="alice"),
        sp("bob", "wire.device_wait", 13.1, 0.3, peer="alice"),
        sp("bob", "wire.device_wait", 13.9, 0.5, peer="alice"),  # half of it inside
        sp("bob", "wire.device_wait", 13.5, 0.2, peer="carol"),  # another peer's
        sp("alice", "wire.send", 15.0, 0.2, peer="bob"),
        sp("alice", "wire.frame", 15.0, 0.2, peer="bob"),
        sp("alice", "wire.send", 19.9, 2.0, peer="bob"),  # runs past the traced rounds
    ]
    assert read("wire.transfer_ms", ctx_of(rows)) == pytest.approx((1000 - 300 - 100 + 200) / 2)


def test_agg_host_is_the_coordinators_work_a_round():
    rows = []
    for t in (11.0, 15.0):
        rows += [sp("alice", "agg.stage", t, 0.01), sp("alice", "agg.launch", t + 0.01, 0.02),
                 sp("alice", "agg.finalize", t + 0.5, 0.03), sp("alice", "agg.wait", t, 0.4),
                 sp("alice", "agg.fold", t, 0.6), sp("bob", "agg.launch", t, 0.5)]
    rows.append(sp("alice", "agg.finalize", 19.99, 0.5))  # runs past the traced rounds
    assert read("agg.host_ms", ctx_of(rows), "llama") == pytest.approx(60.0)


def test_idle_unattributed_counts_gaps_that_only_waits_cover():
    kernels = [["alice", "k", 10.0, 2.0], ["bob", "k", 14.0, 6.0]]  # idle: [12, 14]
    rows = [
        sp("alice", "exec.call", 12.0, 0.5, fn="Trainer.train"),  # work: 0.5 of the gap
        sp("bob", "mailbox.wait", 12.5, 1.5),  # a wait covers the rest: unattributed
        sp("bob", "wire.frame", 12.5, 1.5, peer="alice"),  # a container: unattributed
        sp("bob", "wire.socket", 13.5, 0.1, peer="alice"),  # work
        sp("carol", "wire.socket", 13.55, 0.1, peer="alice"),  # overlaps bob's: counted once
        sp("alice", "agg.launch", 11.0, 0.5),  # under a kernel: not idle time
    ]
    assert read("idle_unattributed", ctx_of(rows, kernels)) == pytest.approx(100 * (2 - 0.65) / 2)
    only_waits = [sp("alice", "exec.call", 11.0, 0.5, fn="Trainer.train"), sp("bob", "agg.wait", 12.0, 2.0)]
    assert read("idle_unattributed", ctx_of(only_waits, kernels)) == pytest.approx(100.0)


def test_readers_are_silent_without_a_trace_or_the_spans():
    full = [sp("alice", "exec.call", 11.0, 0.5, fn="Trainer.train"), sp("bob", "wire.send", 13.0, 1.0, peer="a"),
            sp("bob", "wire.device_wait", 13.1, 0.3, peer="a"), sp("alice", "agg.launch", 11.0, 0.1)]
    kernels = [["alice", "k", 10.0, 1.0]]
    for name in NEW:
        assert read(name, ctx_of(full, kernels, traced=False)) is None, name
        assert read(name, ctx_of([], kernels)) is None, name
        assert read(name, ctx_of(full, kernels)) is not None, name
    # Spans of a program without the stage spans: what the parent of this
    # reader's program records.
    old = [sp("alice", "wire.send", 13.0, 1.0, peer="bob"), sp("alice", "agg.fold", 12.0, 1.0),
           sp("alice", "agg.finalize", 13.0, 0.1), sp("bob", "wire.deliver", 13.0, 0.5)]
    for name in NEW:
        assert read(name, ctx_of(old, kernels)) is None, name
    assert read("idle_unattributed", ctx_of(full, None)) is None
    for name in NEW:  # a run off the card, as the CPU tests make
        assert read(name, {**ctx_of(full, kernels), "platform": "cpu"}) is None, name


def test_work_spans_hold_no_container_or_wait():
    waits = {"driver.round", "wire.send", "wire.frame", "agg.fold", "mailbox.wait", "exec.args", "agg.wait",
             "wire.loop_wait", "trainer.train"}
    assert not waits & set(spans.WORK_SPANS)
