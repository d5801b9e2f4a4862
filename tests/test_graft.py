"""Driver-interface tests: __graft_entry__ and bench contract."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_various_counts():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
        graft.dryrun_multichip(2)
        graft.dryrun_multichip(8)
    finally:
        sys.path.pop(0)


def test_entry_shapes():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
        fn, args = graft.entry()
        params, tokens, lengths, feats = args
        assert tokens.shape[0] == lengths.shape[0] == feats.shape[0]
        assert feats.shape[1] == 4096
        assert callable(fn)
    finally:
        sys.path.pop(0)


def test_bench_script_contract():
    """bench.py must exist and expose the one-JSON-line contract, with
    the device stamp on every line."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    assert "json.dumps" in src
    for key in ("metric", "value", "unit", "platform", "device_kind",
                "device_count"):
        assert key in src
