"""The port's AlexNet configs equal the reference's field for field."""
import dataclasses

import pytest

from repro.configs import alexnet as jax_cfgs
from repro_torch.configs import alexnet as port_cfgs

NAMES = ["CONFIG", "SMOKE", "FAITHFUL", "FAITHFUL_SMOKE"]
# fields of the reference the port leaves out until it has their slices
NOT_PORTED = set()
# the port's policy types are its own (backends auto|plain|cuda; torch
# dtypes), compared field by field below
OWN_TYPE = {"kernels", "exchange", "numerics"}


def _fields(cfg):
    return {f.name for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_match_reference(name):
    port, ref = getattr(port_cfgs, name), getattr(jax_cfgs, name)
    assert _fields(ref) - _fields(port) == NOT_PORTED
    assert _fields(port) <= _fields(ref)
    for f in _fields(port) - OWN_TYPE:
        if f == "convs":
            assert [dataclasses.asdict(c) for c in port.convs] == \
                [dataclasses.asdict(c) for c in ref.convs]
        else:
            assert getattr(port, f) == getattr(ref, f), f
    for f in ("exchange", "numerics"):
        assert dataclasses.asdict(getattr(port, f)) == \
            dataclasses.asdict(getattr(ref, f)), f


@pytest.mark.parametrize("name", NAMES)
def test_n_params_match_reference(name):
    assert (getattr(port_cfgs, name).n_params()
            == getattr(jax_cfgs, name).n_params())


def test_faithful_has_the_canonical_61m_params():
    assert port_cfgs.FAITHFUL.n_params() == 60_965_224


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("size", [227, 128, 64, 48, 35, 20, 9])
def test_feature_hw_matches_reference(name, size):
    port, ref = getattr(port_cfgs, name), getattr(jax_cfgs, name)
    try:
        want = ref.feature_hw(size)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port.feature_hw(size)
        assert str(got.value) == str(e)
    else:
        assert port.feature_hw(size) == want


def test_groups_error_matches_reference():
    def bad(mod):
        return mod.AlexNetConfig(name="bad", convs=(
            mod.ConvSpec(96, 11, 4, 0, pool=True, lrn=True, groups=2),))

    with pytest.raises(ValueError) as ref_err:
        bad(jax_cfgs)
    with pytest.raises(ValueError) as port_err:
        bad(port_cfgs)
    assert str(port_err.value) == str(ref_err.value)
    assert "groups=2 must divide in=3" in str(port_err.value)
