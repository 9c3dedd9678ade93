"""Kernel F's plain version (roma_tpu_torch.ops.compact_miss) against the JAX
package's compaction kernel in interpret mode: exact equality of the slot
positions, sentinel T included, at random densities and at the edges; the
port's copy of _query_subblock; and compact_checks, the kernel's argument
contract and path choice, on meta tensors and offset views."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import window_util as jwu
from roma_tpu_torch.ops import compact_miss
from roma_tpu_torch.ops import window_util as wu
from roma_tpu_torch.ops.window_util import _query_subblock


@pytest.mark.parametrize("t,kf,density", [(64, 8, 0.0), (64, 8, 0.05), (256, 32, 0.05),
                                          (256, 32, 0.5), (256, 16, 1.0), (1024, 64, 0.02)])
def test_compact_miss_matches_pallas_interpret(t, kf, density):
    rs = np.random.RandomState(t + kf)
    miss = rs.rand(12, 1, t) < density
    ref = np.asarray(jwu._compact_miss(jnp.asarray(miss), t, kf, interpret=True))
    got = compact_miss(torch.from_numpy(miss), t, kf)
    assert got.dtype == torch.int32 and tuple(got.shape) == (12, kf, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert compact_miss.launches == 0


@pytest.mark.parametrize("t,cap", [(256, 1024), (4096, 1024), (1000, 512), (97, 32), (360, 100)])
def test_query_subblock_matches_jax(t, cap):
    assert _query_subblock(t, cap) == jwu._query_subblock(t, cap)


def edge_flags(kind, bnt, t, kf, rs):
    """Kernel F's edge cases: no flag, every flag, exactly kf flags, and
    flags only at positions >= kf."""
    if kind == "none":
        return np.zeros((bnt, 1, t), bool)
    if kind == "all":
        return np.ones((bnt, 1, t), bool)
    miss = np.zeros((bnt, 1, t), bool)
    for row in miss[:, 0]:
        lo = 0 if kind == "exactly_kf" else kf
        row[lo + rs.choice(t - lo, min(kf, t - lo), replace=False)] = True
    return miss


@pytest.mark.parametrize("kind", ["none", "all", "exactly_kf", "past_kf"])
@pytest.mark.parametrize("t,kf", [(256, 32), (100, 16), (4096, 64)])
def test_compact_miss_edges_match_pallas_interpret(kind, t, kf):
    rs = np.random.RandomState(t + kf)
    miss = edge_flags(kind, 5, t, kf, rs)
    ref = np.asarray(jwu._compact_miss(jnp.asarray(miss), t, kf, interpret=True))
    np.testing.assert_array_equal(compact_miss(torch.from_numpy(miss), t, kf).numpy(), ref)
    filled = (ref < t).sum(axis=1)[:, 0]
    assert (filled == {"none": 0, "all": kf, "exactly_kf": kf, "past_kf": min(kf, t - kf)}[kind]).all()


@pytest.mark.parametrize("t,offset,path", [
    (256, 0, "warp"), (128, 8, "warp"), (8, 0, "warp"), (256, 1, "generic"), (256, 4, "generic"),
    (4096, 0, "block"), (4096, 16, "block"), (4096, 8, "generic"), (512, 0, "block"), (16384, 0, "block"),
    (16400, 0, "generic"), (264, 0, "generic"), (100, 0, "generic"), (4100, 0, "generic")])
def test_compact_checks_picks_the_path(t, offset, path):
    base = torch.empty(3 * t + 64, dtype=torch.bool, device="meta")
    miss = base[offset:offset + 3 * t].view(3, 1, t)
    assert miss.data_ptr() % 16 == offset % 16
    assert wu.compact_checks(miss, t, 32) == path


def test_compact_checks_on_a_cpu_offset_view():
    """A real buffer: a view 1 byte past a 16-byte base must take the generic path."""
    buf = torch.zeros(2 * 256 + 32, dtype=torch.bool)
    start = (-buf.data_ptr()) % 16
    assert wu.compact_checks(buf[start:start + 512].view(2, 1, 256), 256, 32) == "warp"
    assert wu.compact_checks(buf[start + 1:start + 513].view(2, 1, 256), 256, 32) == "generic"


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(2, 1, 64, dtype=torch.uint8), "bool"),
    (lambda: torch.zeros(2, 64, dtype=torch.bool), "bool"),
    (lambda: torch.zeros(2, 1, 32, dtype=torch.bool), "bool"),
    (lambda: torch.zeros(2, 1, 128, dtype=torch.bool)[..., ::2], "contiguous"),
    (lambda: torch.empty(2**31, 1, 64, dtype=torch.bool, device="meta"), "32-bit"),
])
def test_compact_checks_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        wu.compact_checks(bad(), 64, 8)


def test_compact_checks_refuses_a_t_past_the_chunk_limit():
    t = wu.INT_MAX - 1000
    with pytest.raises(ValueError, match="32-bit"):
        wu.compact_checks(torch.empty(1, 1, t, dtype=torch.bool, device="meta"), t, 8)
