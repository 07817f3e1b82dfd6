"""Per-platform plan cache.

The analog of the reference's TunerResults.dat persistence, consumed back by
CreatePlan's file overload (Plan.h:197-255): a JSON file keyed by
(fft_length, precision, platform[, batch]) whose entries are ``tuning`` dicts
for :func:`tensorfft_tpu.plan.create_plan`.
"""

from tensorfft_tpu.tuning.cache import TunerCache, default_cache_path
