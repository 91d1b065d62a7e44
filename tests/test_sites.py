"""ccve.bench.sites at tiny sizes on the CPU: every site runs, and the
sites that compute one join agree with each other and with NumPy. The
timing itself refuses a non-GPU device."""

import jax
import numpy as np

from ccve.bench import sites


def test_sites_run_and_agree():
    s = sites.sites(n_build=4096, n_probe=65536, n_sort=5000,
                    c3_rhs=256, block=256, seg_chunks=4)
    out = {name: jax.block_until_ready(fn(*args))
           for name, (fn, args) in s.items()}
    for name in ("sort_i32", "sort_i64"):
        x = np.asarray(out[name])
        assert (np.diff(x) >= 0).all() and x.size == 5000
    c32, p32 = map(int, out["count_side_i32"])
    c64, p64 = map(int, out["count_side_i64"])
    assert (c32, p32) == (c64, p64)
    st = out["stats"]
    assert int(np.asarray(st.mult).sum()) == c32
    assert int(np.asarray(st.psum).sum()) == p32
    assert int(out["expand"][3]) == c32
    for a, b in zip(out["lp_drain_compacted"], out["lp_drain_full_width"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(np.asarray(out["lp_drain_full_width"].mult).sum()) == c32
    keys, _, idx = map(np.asarray, out["lp_compaction_step"])
    live = np.asarray(s["lp_compaction_step"][1][0])
    n_live = min(int(live.sum()), keys.size)
    assert np.array_equal(idx[:n_live], np.nonzero(live)[0][:n_live])
    # strategy NONE caches nothing: one segment scan counts every row
    from chip_smoke import np_join
    from ccve.core.datagen import gen_probe_table, gen_rhs_table

    ck, cp = gen_rhs_table(256, 1)
    want = np_join(ck, cp, gen_probe_table(4 * 256, 4, 512))[0]
    assert int(out["sorted_drain_segment"].result_count) == want


def test_sites_main_refuses_cpu():
    assert sites.main(["--reps", "1"]) == 2
