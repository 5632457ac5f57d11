"""The port's negotiated-congestion router (the JAX package's route/).

Layer map (reference equivalents):
  device_graph  — rr-graph tables on the device (the ELL form for the
                  ELL program)
  planes        — structured scan/shift relaxation over [B, W, X, Y]
                  wire canvases, its kernels in planes_kernels /
                  shard_kernels (csrc/*.cu on the card)
  search        — gather-based ELL relaxation (the ELL program)
  router        — PathFinder outer loop / windowed rip-up-reroute driver
  check         — legality oracle (check_route.c)
  serial_ref    — the serial host PathFinder oracle; serial_native its
                  C++ core (native/serial_route.cc)
  qor           — crit-path parity harness vs the serial oracle

The names the JAX package's ``route/__init__.py`` exports are exported
here too (but ``enable_persistent_compile_cache``, XLA's cache: the
port's is ``RouterOpts.compile_cache_dir``), each imported on first
use, so that ``import parallel_eda_tpu_torch.route`` (which every
submodule import runs) pulls in no router, device graph or torch.
"""

import importlib

_EXPORTS = {
    "RouteError": "check", "check_route": "check",
    "DeviceRRGraph": "device_graph", "to_device": "device_graph",
    "PlanesGraph": "planes", "build_planes": "planes",
    "QorRow": "qor", "qor_compare": "qor",
    "RouteResult": "router", "Router": "router", "RouterOpts": "router",
    "RouteStats": "router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
