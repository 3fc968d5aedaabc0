"""The data-parallel gate front (concrete_tpu_torch.parallel.serve) in gloo
CPU processes at a tiny configuration: one front of four ranks for the
module, every gate bit for bit the single-device ServerKey's and the
benchmark's plain reference's (portbench/plain/boolean.py) on batches whose
rows are no multiple of ranks x tier, so padding runs; the bytes a call
hands to collectives and the rows it pads, as planned; the reduced-
precision twin switched on every rank; close() leaving no process; a
killed worker making the next call raise within the group's timeout."""

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from concrete_tpu_torch.boolean import ServerKey
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import BooleanParameters
from concrete_tpu_torch.parallel import mesh as pmesh
from concrete_tpu_torch.parallel import serve
from concrete_tpu_torch.torus import to_numpy
from portbench.plain import boolean as plain

# the published structure (k=2, PBS bl 8 l 2, KS bl 2 l 5) at small n, N
P = {"lwe_dimension": 10, "glwe_dimension": 2, "polynomial_size": 64,
     "lwe_modular_std_dev": 2.0 ** -25, "glwe_modular_std_dev": 2.0 ** -28,
     "pbs_base_log": 8, "pbs_level": 2, "ks_base_log": 2, "ks_level": 5}
WORLD, TIER = 4, 4
SHAPE = (13,)              # 13 rows: each rank's 4 padded to tier 4, 16 in all
PADDED = 16
GATES = ["and", "nand", "or", "nor", "xor", "xnor"]
METHODS = {"and": "and_", "or": "or_", "nand": "nand", "nor": "nor",
           "xor": "xor", "xnor": "xnor"}


def _params():
    return BooleanParameters(
        lwe_dimension=P["lwe_dimension"], glwe_dimension=P["glwe_dimension"],
        polynomial_size=P["polynomial_size"],
        lwe_modular_std_dev=StandardDev(P["lwe_modular_std_dev"]),
        glwe_modular_std_dev=StandardDev(P["glwe_modular_std_dev"]),
        pbs_base_log=P["pbs_base_log"], pbs_level=P["pbs_level"],
        ks_base_log=P["ks_base_log"], ks_level=P["ks_level"])


def _key(seed: int):
    """The plain reference's keys from a seed, and the ServerKey of their
    standard forms on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    keys = plain.make_keys(gen, dict(P, bits=32), "cpu")
    sks = ServerKey.from_arrays(to_numpy(keys["bsk"].to(torch.int32)),
                                to_numpy(keys["ksk"].to(torch.int32)),
                                _params(), device="cpu")
    return gen, keys, sks


@pytest.fixture(scope="module")
def group():
    gen, keys, sks = _key(3)
    front = serve.GateFront(sks, WORLD)
    try:
        front.warmup(batch_sizes=(TIER,), gates=("and",))
        yield gen, keys, sks, front
    finally:
        front.close()


def _inputs(gen, keys, shape=SHAPE):
    bits = [torch.randint(0, 2, shape, generator=gen).bool()
            for _ in range(2)]
    cts = [plain.encrypt(gen, keys, dict(P, bits=32), b) for b in bits]
    return bits, [to_numpy(c.to(torch.int32)) for c in cts]


@pytest.mark.parametrize("gate", GATES)
def test_gate_bit_for_bit(group, gate):
    gen, keys, sks, front = group
    bits, (a, b) = _inputs(gen, keys)
    got = getattr(front, METHODS[gate])(a, b)
    assert got.shape == SHAPE + (P["lwe_dimension"] + 1,)
    assert torch.equal(got, getattr(sks, METHODS[gate])(a, b))
    cts = [torch.from_numpy(x.astype(np.int64)) for x in (a, b)]
    assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF,
                       plain.gate(keys, dict(P, bits=32), gate, cts))
    assert torch.equal(plain.decrypt(keys, got.to(torch.int64) & 0xFFFFFFFF),
                       plain.truth(gate, bits))


def test_broadcast_shapes_and_not(group):
    """Operands broadcast together keep their leading shape; NOT is rank
    0's free negation."""
    gen, keys, sks, front = group
    _, (a, b) = _inputs(gen, keys, (3, 5))
    got = front.xor(a, b[:1])
    assert got.shape == (3, 5, P["lwe_dimension"] + 1)
    assert torch.equal(got, sks.xor(a, b[:1]))
    assert torch.equal(front.not_(a), sks.not_(a))
    empty = front.and_(a[:0], b[:0])
    assert empty.shape == sks.and_(a[:0], b[:0]).shape == (0, 5, 11)


def test_sent_bytes_and_rows_as_planned(group):
    gen, keys, sks, front = group
    _, (a, b) = _inputs(gen, keys)
    pmesh.reset_sent_bytes()
    rows0 = dict(serve.DP_ROWS.by_key)
    front.and_(a, b)
    row = (P["lwe_dimension"] + 1) * 4
    assert pmesh.SENT.by_key == {"broadcast": PADDED * row,
                                 "all_gather": PADDED // WORLD * row}
    assert pmesh.sent_bytes() == serve.planned_sent_bytes(sks.cfg, PADDED,
                                                          WORLD)
    assert serve.DP_ROWS.by_key["request"] - rows0["request"] == SHAPE[0]
    assert (serve.DP_ROWS.by_key["padding"] - rows0["padding"]
            == PADDED - SHAPE[0])


def test_mux_is_not_served(group):
    front = group[3]
    with pytest.raises(NotImplementedError):
        front.mux(None, None, None)
    with pytest.raises(NotImplementedError):
        front.warmup(mux=True)


def test_fast_mode_on_every_rank(group):
    """The control the benchmark runs: every rank's reduced-precision twin,
    bit for bit the single-device twin's (the module's last use of the
    front's full-precision key)."""
    gen, keys, sks, front = group
    _, (a, b) = _inputs(gen, keys)
    assert front.with_fast_mode(levels=1) is front
    front.warmup(batch_sizes=(TIER,))
    assert torch.equal(front.and_(a, b),
                       sks.with_fast_mode(levels=1).and_(a, b))


def _alive(pids):
    return [p.pid for p in multiprocessing.active_children()
            if p.pid in pids]


def test_close_leaves_no_process(group):
    front = group[3]
    assert len(_alive(front.pids)) == WORLD - 1
    front.close()
    front.close()
    assert _alive(front.pids) == []
    with pytest.raises(RuntimeError, match="closed"):
        front.and_(np.zeros((1, 11), np.uint32), np.zeros((1, 11), np.uint32))


def test_killed_worker_makes_the_next_call_raise():
    gen, keys, sks = _key(4)
    front = serve.GateFront(sks, 2)
    try:
        _, (a, b) = _inputs(gen, keys)
        assert torch.equal(front.and_(a, b), sks.and_(a, b))
        os.kill(front.pids[0], signal.SIGKILL)
        deadline = time.monotonic() + 10
        while _alive(front.pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exited"):
            front.and_(a, b)
        assert time.monotonic() - t0 < serve.TIMEOUT_S
        assert _alive(front.pids) == []
        with pytest.raises(RuntimeError, match="closed"):
            front.and_(a, b)
    finally:
        front.close()
