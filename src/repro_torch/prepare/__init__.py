"""``repro_torch.prepare``: offline model preparation (§4.4), counterpart of
``repro/prepare``.

One interface over every offline transform the serving and vision paths
need (per-channel int8 weights with Eq. 15 folded beta and colsums, the
Eq. 9 y deltas and on the card their K3 carry tables, folded BN, and the
device-keyed ``repro_torch.tune`` schedule slice), serializable to one
artifact directory in the reference's format, with a counter-proved
zero-recompute warm start. See :mod:`repro_torch.prepare.artifact`.

    pm = prepare.prepare_lm(params, quantized=True)
    pm.save("artifacts/minicpm")
    ...
    pm = prepare.load("artifacts/minicpm")     # a new process
    BatchServer(model, ..., prepared=pm)       # derives nothing
    assert pm.recomputed == 0

CLI: ``python -m repro_torch.launch.prepare``.
"""
from repro_torch.prepare.artifact import (ArtifactError, PreparedModel,
                                          counters_snapshot, load,
                                          prepare_lm, prepare_vision)

__all__ = ["ArtifactError", "PreparedModel", "counters_snapshot", "load",
           "prepare_lm", "prepare_vision"]
