"""repro_torch.fleet: the asynchronous federated round server, the port's
own copy of ``repro/fleet``.

A virtual-clock fleet simulator (``simulator.py``) decides when each
dispatched client finishes; the client computation is the round object's
own client phase, one stacked call per dispatch cohort; completed changes
land in a staleness-weighted buffer (``buffer.py``); clients are drawn
without replacement by an epoch-permutation sampler (``sampler.py``); the
event loop (``server.py``) is :class:`repro_torch.api.AsyncTrainer`.

This package never constructs rounds: it drives the round object handed to
it (built by ``repro_torch.api.fed_round``) and imports neither
``repro_torch.core.fedavg`` nor ``repro_torch.api``.  Attribute access is
lazy, so the numpy-only consumers (``data/federated.py`` uses the sampler)
do not import the server.
"""
_EXPORTS = {
    "AsyncTrainer": "repro_torch.fleet.server",
    "DeltaBuffer": "repro_torch.fleet.buffer",
    "ClientReport": "repro_torch.fleet.buffer",
    "STALENESS_POLICIES": "repro_torch.fleet.buffer",
    "resolve_staleness": "repro_torch.fleet.buffer",
    "EpochPermutationSampler": "repro_torch.fleet.sampler",
    "SERVER_LR_SCHEDULES": "repro_torch.fleet.sampler",
    "resolve_server_lr_schedule": "repro_torch.fleet.sampler",
    "FleetSimulator": "repro_torch.fleet.simulator",
    "LatencyModel": "repro_torch.fleet.simulator",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'repro_torch.fleet' has no attribute {name!r}")


def __dir__():
    return __all__
