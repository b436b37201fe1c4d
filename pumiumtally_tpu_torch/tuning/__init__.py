"""Shape-class autotuning of the port's own knobs.

Counterpart of ``pumiumtally_tpu/tuning/``. The walk kernel's threads per
block (``ops/walk_cuda.py``, the counterpart of the JAX kernel's
``lane_block``) and the megastep K are searched per padded ``(ntet,
n_particles, n_groups, dtype, packed)`` shape class by ``tuning/search.py``
(run as ``python -m pumiumtally_tpu_torch.tuning``), every candidate
gated bitwise against the reference, and kept in an environment-keyed
``TUNING_TORCH.json`` (``tuning/db.py``) that the facades consult once at
construction through :func:`resolve_tuned`. Env variables and explicit
config fields beat the database; a miss leaves today's defaults.
"""
from .db import (  # noqa: F401
    TUNING_FILE,
    TUNING_OFF,
    TUNING_SCHEMA,
    TunedDecision,
    TuningDB,
    empty_db,
    env_key,
    environment,
    load_tuning,
    lookup_tuned,
    resolve_tuned,
    write_tuning,
)
from .shapes import PAD_FLOOR, ShapeClass, bucket, classify  # noqa: F401
