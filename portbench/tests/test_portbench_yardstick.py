"""The frozen work counts and peaks against the program's own
(concrete_tpu_torch/profiling.py, design.py) at the cells' shapes: equal
today; a later change to the program's copies leaves the yardstick as it
is."""

import pytest

from portbench import harness, yardstick


def cell_params(config: str) -> dict:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == config)
    bits = {"boolean_default": 32, "int4_lut": 64}[config]
    return dict(harness.load_json(harness.ROOT / conf["file"])["parameters"],
                bits=bits)


def test_peaks():
    from concrete_tpu_torch import profiling

    assert yardstick.HBM_BYTES_PER_S == profiling.HBM_BYTES_PER_S
    assert yardstick.INT8_TENSOR_OPS_PER_S == profiling.INT8_TENSOR_OPS_PER_S
    assert yardstick.SM_CLOCKS_PER_S == profiling.SM_CLOCKS_PER_S
    assert (yardstick.PIPE_LANES, yardstick.ISSUE_LANES) == (
        profiling.PIPE_LANES, profiling.ISSUE_LANES)
    for instr in [(1e9, 2e9, 3e9), (5e9, 0, 1e8), (0, 7e9, 0)]:
        assert yardstick.int_ops_s(*instr) == profiling.int_ops_s(*instr)


@pytest.mark.parametrize("batch", [1, 16, 256, 2048, 4096])
def test_ntt_cmux_work(batch):
    from concrete_tpu_torch import profiling
    from concrete_tpu_torch.core.bootstrap import ServerConfig
    from concrete_tpu_torch.params import DEFAULT_PARAMETERS

    cfg = ServerConfig.from_boolean_parameters(DEFAULT_PARAMETERS)
    p = cell_params("boolean_default")
    assert yardstick.ntt_cmux_work(p["polynomial_size"],
                                   p["glwe_dimension"] + 1, p["pbs_level"],
                                   batch) == profiling.ntt_cmux_work(
        cfg, batch)[1]


@pytest.mark.parametrize("batch", [1, 16, 2048])
def test_keyswitch_int8_ops(batch):
    from concrete_tpu_torch import design
    from concrete_tpu_torch.params import DEFAULT_PARAMETERS

    assert yardstick.keyswitch_int8_ops(cell_params("boolean_default"),
                                        batch) == design._ks_int8_ops(
        DEFAULT_PARAMETERS, batch)


@pytest.mark.parametrize("batch", [16, 2048])
def test_toeplitz_counts(batch):
    from concrete_tpu_torch import profiling
    from concrete_tpu_torch.core.bootstrap import ServerConfig
    from concrete_tpu_torch.core.bootstrap_mxu import MxuPlan

    p = cell_params("int4_lut")
    cfg = ServerConfig(p["lwe_dimension"], p["glwe_dimension"],
                       p["polynomial_size"], p["pbs_base_log"],
                       p["pbs_level"], p["ks_base_log"], p["ks_level"],
                       bits=64)
    plan = MxuPlan.from_config(cfg)
    assert yardstick.n_sub(p["pbs_base_log"]) == plan.n_sub
    assert yardstick.mxu_gemm_ops(p, batch) == profiling.mxu_gemm_ops(
        plan, batch)
    assert yardstick.rotdig64_work(plan.base_log, plan.level,
                                   plan.n_sub) == profiling.rotdig64_work(plan)
    fast = MxuPlan.from_config(cfg.with_fast_mode(limb_drop=2))
    assert yardstick.mxu_gemm_ops(p, batch, 2) == profiling.mxu_gemm_ops(
        fast, batch)


def test_roofline_bounds_at_the_cells():
    """The least times the roofline shares divide by: K9's integer work
    bounds a DEFAULT gate call, the int8 GEMM the int4 PBS."""
    gate = yardstick.ntt_gate_work(cell_params("boolean_default"), 2048,
                                   2048, 2)
    assert gate.bound_seconds() == yardstick.int_ops_s(*gate.int_instr)
    assert 0.015 < gate.bound_seconds() < 0.03
    pbs = yardstick.mxu_pbs_work(cell_params("int4_lut"), 2048)
    tensor_s = pbs.int8_ops / yardstick.INT8_TENSOR_OPS_PER_S
    assert pbs.bound_seconds() == tensor_s
    assert 0.12 < pbs.bound_seconds() < 0.15
