"""The port's sharded gate pipelines (concrete_tpu_torch.parallel) in gloo
CPU process groups, bit for bit against concrete_tpu's single-device calls
(which tests/test_parallel.py holds equal to its mesh pipelines).

One module-scoped fixture spawns three groups (4 ranks: dp x tp in 4x1,
2x2, 1x4; 3 ranks: tp=3 and the refusals; 5 ranks: tp=5); their ranks run
`dryrun.run_cases` (each shard and gathered batch also checked there
against the port's own single-device call) and leave their outputs in a
temp dir. Every case is then compared here with the JAX package's call on
the same numpy inputs (`dryrun.case_inputs`), computed once per
(configuration, backend, batch). Tolerance: none. Each pipeline's
`graphed` (recorded by run_cases) is held to the rule of mesh._compiled:
graphed where it makes no collective (dp) or its tp group has one rank,
eager for tp > 1 on gloo.
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu.core import bootstrap as jbs
from concrete_tpu.core import bootstrap_mxu as jbsx
from concrete_tpu.core import bootstrap_nuss as jbsn
from concrete_tpu.core import checks as jchecks
from concrete_tpu.parallel import mesh as jmesh
from concrete_tpu_torch.core import checks
from concrete_tpu_torch.parallel import dryrun, mesh, multihost

# (name, configuration, pipeline, dp, tp): the matrix of
# __graft_entry__.dryrun_multichip and tests/test_parallel.py at TINY sizes
GROUPS = {
    4: [("u32 dp mxu 4x1", "u32 bl8", "dp mxu", 4, 1),
        ("u32 dp ntt 4x1", "u32 bl8", "dp ntt", 4, 1),
        ("u32 dp mxu 2x2", "u32 bl8", "dp mxu", 2, 2),
        ("u32 mxu 4x1", "u32 bl8", "mxu", 4, 1),
        ("u32 mxu 2x2", "u32 bl8", "mxu", 2, 2),
        ("u32 mxu 1x4", "u32 bl8", "mxu", 1, 4),
        ("u32 ntt 2x2", "u32 bl8", "ntt", 2, 2),
        ("u32 lut mxu 1x4", "u32 tp4 lut", "mxu", 1, 4),
        ("u32 lut ntt 1x4", "u32 tp4 lut", "ntt", 1, 4),
        ("u64 mxu 2x2", "u64", "mxu", 2, 2),
        ("u64 ntt 2x2", "u64", "ntt", 2, 2),
        ("u64 limb_drop=2 mxu 2x2", "u64 drop2", "mxu", 2, 2),
        ("nuss u32 2x2", "nuss u32", "nuss", 2, 2),
        ("nuss u32 1x4", "nuss u32", "nuss", 1, 4),
        ("nuss u64 2x2", "nuss u64", "nuss", 2, 2),
        ("key broadcast 2x2", "u32 bl8", "broadcast", 2, 2)],
    3: [("u32 l=3 mxu 1x3 (keyswitch replicated)", "u32 l3", "mxu", 1, 3),
        ("u32 l=3 ntt 1x3 (keyswitch replicated)", "u32 l3", "ntt", 1, 3),
        ("refusal mxu row_blocks", "u32 bad", "error mxu", 1, 3),
        ("refusal ntt pbs_level", "u32 bad", "error ntt", 1, 3),
        ("refusal nuss row_blocks", "u32 bad", "error nuss", 1, 3),
        ("refusal ntt envelope", "u64 bl31", "envelope", 1, 3)],
    5: [("u32 k=4 mxu 1x5 (TPU128 shape class)", "u32 k4", "mxu", 1, 5)],
}
CASES = [(world, i, case) for world, cases in GROUPS.items()
         for i, case in enumerate(cases)]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    dirs = {}
    for world, cases in GROUPS.items():
        dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        dryrun.run_group(cases, str(dirs[world]), device="cpu",
                          timeout=300)
    return dirs


def jax_config(config: str):
    return jbs.ServerConfig(
        **dataclasses.asdict(dryrun.CONFIGS[config]["cfg"]))


@functools.lru_cache(maxsize=None)
def jax_reference(config: str, backend: str, batch: int) -> np.ndarray:
    """concrete_tpu's single-device PBS + keyswitch on the case inputs."""
    inp = dryrun.case_inputs(config, backend, batch)
    cfg = jax_config(config)
    ksk, lut, lin = (jnp.asarray(inp[k]) for k in ("ksk", "lut", "lin"))
    if backend == "ntt":
        out = jbs.bootstrap_keyswitch(cfg, jnp.asarray(inp["bsk"]), ksk, lut,
                                      lin)
    elif backend == "nuss":
        lc = dryrun.CONFIGS[config]["l"]
        rings = jnp.asarray(jbsn.bsk_to_nuss(inp["bsk"], cfg, lc))
        out = jbsn.bootstrap_keyswitch_nuss(cfg, rings, ksk, lut, lin, l=lc)
    else:
        rings = jnp.asarray(jbsx.bsk_to_mxu(inp["bsk"], cfg))
        out = jbsx.bootstrap_keyswitch_mxu(cfg, rings, ksk, lut, lin)
    return np.asarray(out)


def _rows_of_rank(rank: int, dp: int, tp: int, pipeline: str, batch: int):
    """The rows rank `rank` of the row-major dp x tp mesh returns."""
    if pipeline.startswith("dp "):          # batch over dp x tp
        step = batch // (dp * tp)
        return slice(rank * step, (rank + 1) * step)
    step = batch // dp                      # batch over dp, tp replicated
    return slice(rank // tp * step, (rank // tp + 1) * step)


@pytest.mark.parametrize(
    "world,i,case", CASES, ids=[case[0] for _, _, case in CASES])
def test_sharded_pipeline_matches_concrete_tpu(outputs, world, i, case):
    name, config, pipeline, dp, tp = case
    out = outputs[world]
    batch = 4 * world
    if pipeline.startswith("error") or pipeline == "envelope":
        err = json.loads((out / f"{i}.json").read_text())
        if pipeline == "envelope":
            with pytest.raises(NotImplementedError) as want:
                jax_config(config)
            assert err == {"type": "NotImplementedError",
                           "message": str(want.value)}
            return
        cfg = jax_config(config)
        make = {"error mxu": lambda m: jmesh.gate_pipeline_dp_tp_mxu(cfg, m),
                "error ntt": lambda m: jmesh.gate_pipeline_dp_tp(cfg, m),
                "error nuss": lambda m: jmesh.gate_pipeline_dp_tp_nuss(
                    cfg, m, l=dryrun.CONFIGS[config]["l"])}[pipeline]
        fragment = {"error mxu": "row_blocks", "error ntt": "pbs_level",
                    "error nuss": "nuss row_blocks"}[pipeline]
        with pytest.raises(jchecks.ShardingMismatch, match=fragment) as want:
            make(jmesh.make_mesh(dp=1, tp=tp))
        assert err["type"] == checks.ShardingMismatch.__name__
        assert err["message"] == str(want.value)
        return
    if pipeline == "broadcast":
        cfg = jax_config(config)
        want = jbsx.bsk_to_mxu(
            dryrun.case_inputs(config, "mxu", batch)["bsk"], cfg)
        assert want.any()
        for rank in range(world):
            np.testing.assert_array_equal(
                np.load(out / f"{i}.r{rank}.npy"), want)
        return
    backend = pipeline.split()[-1]
    want = jax_reference(config, backend, batch)
    np.testing.assert_array_equal(np.load(out / f"{i}.npy"), want)
    for rank in range(world):
        np.testing.assert_array_equal(
            np.load(out / f"{i}.r{rank}.npy"),
            want[_rows_of_rank(rank, dp, tp, pipeline, batch)])
    graphed = json.loads((out / "graphed.json").read_text())[str(i)]
    assert graphed == (pipeline.startswith("dp ") or tp == 1)


@pytest.mark.parametrize("pid,local", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_worker_env_places_ranks_like_torchrun(pid, local):
    env = multihost.worker_env(pid, 2, "localhost:29500", 2, local)
    assert env["RANK"] == str(2 * pid + local)
    assert (env["WORLD_SIZE"], env["LOCAL_WORLD_SIZE"]) == ("4", "2")
    assert (env["LOCAL_RANK"], env["GROUP_RANK"]) == (str(local), str(pid))
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("localhost", "29500")


def test_orientations_put_tp_inside_then_across_hosts():
    (dp_name, dp_grid), (tp_name, tp_grid) = multihost.orientations(2, 2)
    assert dp_grid.tolist() == [[0, 1], [2, 3]]     # tp pairs on one host
    assert tp_grid.tolist() == [[0, 2], [1, 3]]     # tp pairs across hosts
    assert [g.tolist() for _, g in multihost.orientations(2, 1)] == [
        [[0], [1]], [[0, 1]]]


def test_psum_mod_p_reads_int32_bit_patterns_as_unsigned(tmp_path):
    """_psum_mod_p takes the bit patterns to unsigned values in int64
    before the collective (ROADMAP.md hazard 8): an int32 -1 is 2^32 - 1.
    A world of one, so the sum is the value itself."""
    import torch.distributed as dist

    from concrete_tpu_torch.math import ntt

    sp = ntt.make_stacked_plans(8, (2013265921, 1811939329))
    x = torch.tensor([[-1] * 8, [2 ** 31 - 1] * 8], dtype=torch.int32)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = mesh._psum_mod_p(x, sp, None)
    finally:
        dist.destroy_process_group()
    assert got.dtype == torch.int64
    assert got.tolist() == [[(2 ** 32 - 1) % 2013265921] * 8,
                            [(2 ** 31 - 1) % 1811939329] * 8]


def test_shard_refuses_a_batch_dp_does_not_divide():
    class Grid:
        mesh_dim_names = ("dp", "tp")

        def size(self, dim):
            return (3, 1)[dim]

        def get_local_rank(self, axis):
            return 0

    with pytest.raises(checks.ShardingMismatch, match="does not divide"):
        mesh.shard(torch.zeros(8, 4), Grid(), ("dp",))
    assert mesh.shard(torch.arange(9), Grid(), ("dp",)).tolist() == [0, 1, 2]
