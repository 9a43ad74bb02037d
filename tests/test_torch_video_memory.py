"""The port's video eval engine against ``maggie_tpu``'s with the ConvGRU
memory carried across windows (``test.carry_memory``), on
``test_torch_video_engine.py``'s set, model and weights, within the same
rtol 1e-4; and that carrying it changes the windows after a video's first."""

import pytest

import maggie_tpu_torch.engine.test as port_engine
from maggie_tpu_torch.config import load_config
from test_torch_harness import one_torch_thread, port_from_flat  # noqa: F401
from test_torch_video_engine import (CONFIG, _opts, _spy, assert_runs_match, run_both,  # noqa: F401
                                     vim_root, weights)


@pytest.fixture(scope="module")
def carried(vim_root, weights, tmp_path_factory):
    return run_both(vim_root, weights, str(tmp_path_factory.mktemp("carried")), True)


def test_port_test_matches_jax_with_memory_carried(carried):
    assert_runs_match(carried)


def test_carried_memory_changes_the_windows(carried, vim_root, weights, tmp_path):
    """The first window of each video equals the fresh-memory run's; a later
    one differs."""
    cfg = load_config(CONFIG, _opts(vim_root, ["output_dir", str(tmp_path)]))
    fresh = []
    orig = _spy(port_engine, fresh)
    try:
        port_engine.test(cfg, model=port_from_flat(cfg.model, weights[1]))
    finally:
        port_engine.compute_metrics = orig
    got = carried["calls"]["port"]
    assert fresh[0] == got[0] and fresh[4] == got[4]
    assert any(a["MAD"] != b["MAD"] for a, b in zip(fresh[1:4], got[1:4]))
