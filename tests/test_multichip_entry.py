"""The multi-device dry run and the headline entry point must stay green.

``dryrun_multichip`` bootstraps its own CPU mesh rather than asserting on the
device count it finds.  This test runs the real entry point in-process
(conftest already provides the 8-device CPU mesh, exercising the fast
bootstrap path).
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft_entry


def test_dryrun_multichip_8_devices():
    graft_entry.dryrun_multichip(8)


def test_entry_compiles():
    import jax

    fn, args = graft_entry.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == args[0].shape
