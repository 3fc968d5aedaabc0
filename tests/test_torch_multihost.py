"""The port's multi-process rehearsal (concrete_tpu_torch.parallel.multihost)
in gloo CPU processes: the keys replicated from rank 0, the dp x tp mxu
pipeline over the global mesh with dp and then tp across "hosts", every
rank's shard and the gathered batch bit for bit equal to the single-device
call (the ranks check it and exit non-zero otherwise), and the bytes each
rank hands to the collectives equal to the plan's count. The TPU128
real-key tier is marked slow, as tests/test_multihost.py is."""

import pytest

from concrete_tpu_torch.parallel import multihost


def check_stats(stats, world, calls):
    assert len(stats) == world * calls
    assert {s["rank"] for s in stats} == set(range(world))
    for s in stats:
        assert s["sent_bytes"] == s["planned_bytes"], s


def test_multihost_toy_tier_two_processes():
    stats = multihost.run(2, 1, timeout=300, device="cpu",
                          real_keys=False)
    check_stats(stats, 2, 2)
    tp_across = [s for s in stats if "tp-across" in s["tag"]]
    # tp=2 across the processes: every CMux step's partial sum is sent
    assert all(s["sent_bytes"] > 16 * 4 * 17 for s in tp_across)


@pytest.mark.slow
def test_multihost_real_keys_two_processes_two_ranks_each():
    stats = multihost.run(2, 2, timeout=1800, device="cpu")
    check_stats(stats, 4, 4)
    assert any(s["tag"].startswith("TPU128 real keys") for s in stats)


def test_the_entry_points_default_to_the_card():
    """No device named means the card: without CUDA the call raises before
    it spawns anything, and the CPU runs only when asked for."""
    import torch

    from concrete_tpu_torch.parallel import dryrun

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.run(2, 1, real_keys=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2, real_keys=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_group([("u32 dp mxu", "u32 bl8", "dp mxu", 2, 1)], ".")
    assert multihost.placement("cpu", None, 4) == ("cpu", "gloo")


@pytest.mark.parametrize("backend,world,want", [
    (None, 1, ("cuda", "nccl")),
    ("nccl", 1, ("cuda", "nccl")),
    ("gloo", 2, ("cuda", "gloo")),
    (None, 2, ValueError),
    ("nccl", 3, ValueError),
])
def test_placement_never_shares_a_card_on_nccl(monkeypatch, backend, world,
                                               want):
    """On one card NCCL takes one rank; more ranks need gloo named by the
    caller, and the backend is never switched quietly."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if want is ValueError:
        with pytest.raises(ValueError, match="name backend='gloo'"):
            multihost.placement(None, backend, world)
    else:
        assert multihost.placement(None, backend, world) == want


def test_placement_refuses_nccl_for_cpu_ranks():
    with pytest.raises(ValueError, match="CPU ranks take gloo"):
        multihost.placement("cpu", "nccl", 2)
