"""Driver entry points compile and execute (single chip + 8-device dry run)."""

import jax
import numpy as np


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    u, dmeans = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(u)).all()
    assert np.isfinite(np.asarray(dmeans)).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)
