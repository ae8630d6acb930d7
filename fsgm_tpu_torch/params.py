"""SGM parameters, re-exported from fsgm_tpu/params.py (numpy/stdlib only).

SGM has no learned weights: the parameter set is the whole state a run
carries.  Importing it rather than copying it keeps configs/*.json presets
loading identically in both packages.
"""

from fsgm_tpu.params import (DIRS_8, DIRS_16, INVALID, SGMParams,  # noqa: F401
                             load_preset, params_from_json)

__all__ = ["SGMParams", "INVALID", "DIRS_8", "DIRS_16", "load_preset",
           "params_from_json"]
