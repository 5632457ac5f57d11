"""The port's copies of the host front end (arch, netlist, pack, rr graph,
terminals, initial placement) reproduce the JAX package's exactly."""

import dataclasses

import numpy as np
import pytest

from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu_torch.device import resolve_device
from parallel_eda_tpu_torch.flow import synth_flow

CONFIGS = {
    "15lut": dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
                  seed=3),
    "60lut": dict(num_luts=60, num_inputs=12, num_outputs=12,
                  chan_width=12, seed=11),
}

_CACHE = {}


def _flows(name):
    if name not in _CACHE:
        _CACHE[name] = (jax_synth_flow(**CONFIGS[name]),
                        synth_flow(**CONFIGS[name]))
    return _CACHE[name]


def _same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        assert np.array_equal(a, b), what
    elif isinstance(a, (dict, int, float, str, tuple, list)) or a is None:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rr_graph_equal(name):
    jf, tf = _flows(name)
    for f in dataclasses.fields(jf.rr):
        if f.name == "grid":
            continue
        _same(getattr(jf.rr, f.name), getattr(tf.rr, f.name), f.name)
    assert (jf.rr.grid.nx, jf.rr.grid.ny) == (tf.rr.grid.nx, tf.rr.grid.ny)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_terminals_and_placement_equal(name):
    jf, tf = _flows(name)
    assert np.array_equal(jf.pos, tf.pos)
    for f in dataclasses.fields(jf.term):
        _same(getattr(jf.term, f.name), getattr(tf.term, f.name), f.name)
    assert jf.pnl.num_blocks == tf.pnl.num_blocks


def test_device_default_is_cuda():
    import torch

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    else:
        assert resolve_device(None).type == "cuda"
