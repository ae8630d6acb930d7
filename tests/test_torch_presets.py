"""PyTorch port: the presets and parameter classes against the JAX package.

Every configs/*.json loads into the port's own parameter classes with the
JAX package's fields and values and round-trips through the port's JSON;
the constants, the classes' defaults, forgetting_margin and the
fb_backward check equal the JAX package's.
"""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("preset", sorted(
    p.name for p in (REPO / "configs").glob("*.json")))
def test_presets_load_into_equal_parameters(preset):
    """Every configs/*.json loads into the port's own classes with the JAX
    package's fields and values, and round-trips through its JSON."""
    import dataclasses
    from fsgm_tpu import params as jparams
    from fsgm_tpu_torch import params as tparams
    path = str(REPO / "configs" / preset)
    want, got = jparams.load_preset(path), tparams.load_preset(path)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g_ = got[key]
        if not dataclasses.is_dataclass(w):
            assert g_ == w
            continue
        assert type(g_).__module__ == "fsgm_tpu_torch.params"
        assert type(g_).__name__ == type(w).__name__
        assert dataclasses.asdict(g_) == dataclasses.asdict(w)
        assert tparams.params_to_json(g_) == jparams.params_to_json(w)
        assert tparams.params_from_json(tparams.params_to_json(g_)) == g_


def test_param_constants_and_defaults_match_jax():
    import dataclasses
    from fsgm_tpu import params as jparams
    from fsgm_tpu_torch import params as tparams
    for name in ("DIRS_8", "DIRS_16", "INVALID"):
        assert getattr(tparams, name) == getattr(jparams, name)
    for cls in ("SGMParams", "FlowParams", "DistParams"):
        assert dataclasses.asdict(getattr(tparams, cls)()) == \
            dataclasses.asdict(getattr(jparams, cls)())
    for args in ((7, 100), (3, 60, 24), (0, 5)):
        assert tparams.forgetting_margin(*args) == \
            jparams.forgetting_margin(*args)
    with pytest.raises(ValueError, match="fb_backward"):
        tparams.FlowParams(fb_backward="both")
