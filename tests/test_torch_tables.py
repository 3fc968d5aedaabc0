"""The toeplitz tables in the layout the int8 product reads fastest, on the
CPU: build_tables returns its plain version's values in a column-major
matrix (one per group on the Nussbaumer rings), held against the JAX
package's table, and int_mm gives the same product for a row-major and a
column-major right-hand side. Kernel launches are counted per shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_nuss as bsn_t
from concrete_tpu_torch.ops import _cuda


def _rings(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


# (R, k+1, N, n_words, limb_drop, limb_hi_drop, groups)
TABLES = [(4, 2, 16, 1, 0, 0, 1), (6, 3, 32, 1, 1, 0, 1), (6, 2, 32, 2, 0, 0, 1),
          (6, 2, 16, 2, 2, 0, 1), (6, 2, 16, 2, 5, 0, 3), (8, 2, 32, 2, 0, 3, 4),
          (12, 2, 16, 3, 0, 3, 2), (16, 1, 32, 3, 0, 3, 16)]


@pytest.mark.parametrize("r,ks1,n,nw,drop,hd,groups", TABLES)
def test_build_tables_column_major_matches_jax(r, ks1, n, nw, drop, hd, groups):
    rings = _rings(r * n + drop, (r, ks1 * nw, 2 * n))
    want = np.asarray(bsx_jax._build_tables_jnp(jnp.asarray(rings), n, nw,
                                                 drop, hd))
    got = bsx_t.build_tables(torch.from_numpy(rings.view(np.int32)), n, drop,
                             nw, hd, groups=groups)
    rows, cols = r // groups * n, want.shape[1]
    assert got.shape == ((rows, cols) if groups == 1 else (groups, rows, cols))
    assert got.transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(got.reshape(-1, cols).numpy(), want)


def test_build_tables_writes_out_in_any_layout_on_the_cpu():
    rings = torch.from_numpy(_rings(1, (4, 2, 64)).view(np.int32))
    want = bsx_t.build_tables_plain(rings, 32)
    for out in (bsx_t.table_buffer(128, 256),
                torch.empty((128, 256), dtype=torch.int8)):
        assert bsx_t.build_tables(rings, 32, out=out) is out
        assert torch.equal(out, want)
    with pytest.raises(ValueError):
        bsx_t.build_tables(rings, 32, out=torch.empty((256, 128), dtype=torch.int8))
    with pytest.raises(ValueError):
        bsx_t.build_tables(rings, 32, groups=3)


@pytest.mark.parametrize("m,k,n", [(5, 2524, 13), (17, 40, 24), (64, 256, 320),
                                   (33, 96, 8)])
def test_int_mm_takes_either_layout(m, k, n):
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(k, n), dtype=np.int8))
    col = b.t().contiguous().t()
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    np.testing.assert_array_equal(bsx_t.int_mm(a, b).numpy(), want)
    np.testing.assert_array_equal(bsx_t.int_mm(a, col).numpy(), want)
    out = torch.empty((m, n), dtype=torch.int32)
    assert bsx_t.int_mm(a, col, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_nuss_step_product_on_the_grouped_tables():
    """One frequency's product on the grouped column-major table equals the
    product on the plain table's slice (the Nussbaumer step's dot)."""
    from concrete_tpu_torch.core import bootstrap as bs

    cfg = bs.ServerConfig(lwe_dimension=2, glwe_dimension=1,
                          polynomial_size=256, pbs_base_log=7, pbs_level=2,
                          ks_base_log=2, ks_level=5)
    plan = bsn_t.NussPlan.from_config(cfg, 8)
    rings = torch.from_numpy(_rings(5, (plan.two_l * plan.row_blocks,
                                        plan.glwe_size * plan.n_words,
                                        2 * plan.m)).view(np.int32))
    d8, rhs, s = bsn_t._step_buffers(plan, 3, "cpu")
    d8.copy_(torch.from_numpy(np.random.default_rng(6).integers(
        -64, 65, size=d8.shape, dtype=np.int8)))
    got = bsx_t.build_tables(rings, plan.m, 0, plan.n_words,
                             plan.limb_hi_drop, groups=plan.two_l, out=rhs)
    assert got is rhs and rhs.transpose(1, 2).is_contiguous()
    plain = bsx_t.build_tables_plain(rings, plan.m, 0, plan.n_words,
                                     plan.limb_hi_drop).view(rhs.shape)
    for z in (0, plan.two_l - 1):
        assert torch.equal(bsx_t.int_mm(d8[z], rhs[z]),
                           bsx_t.int_mm(d8[z], plain[z]))


def test_launches_are_counted_per_shape():
    def kernel():
        pass

    _cuda.counter(kernel)
    for b in (2, 2, 4):
        _cuda.count_launch(kernel, B=b, N=64)
    assert kernel.launches == 3
    assert kernel.shapes == {"B=2 N=64": 2, "B=4 N=64": 1}
    bsx_t.reset_launch_counts()
    bsn_t.reset_launch_counts()
    assert all(not v for v in bsx_t.shape_counts().values())
    assert set(bsn_t.shape_counts()) == set(bsn_t.launch_counts())
