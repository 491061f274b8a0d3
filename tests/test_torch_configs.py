"""The port's config schema and presets against the JAX package's: same
dataclasses, same fields and defaults, same presets, and config JSON
written by either package loads in the other."""

from __future__ import annotations

import dataclasses
import inspect
import json

import pytest

from heterofusionrcnn_tpu.configs import config as jax_config
from heterofusionrcnn_tpu.configs import presets as jax_presets

from heterofusionrcnn_torch.configs import config as torch_config
from heterofusionrcnn_torch.configs import presets as torch_presets


def _dataclasses(mod):
    return {
        name: obj for name, obj in vars(mod).items()
        if dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__
    }


def _norm(value):
    """Dataclasses (also inside lists) as plain JSON values."""
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    elif isinstance(value, list):
        value = [dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for v in value]
    return json.loads(json.dumps(value))


def _defaults(cls):
    return {
        f.name: _norm(f.default_factory() if f.default_factory is not dataclasses.MISSING
                      else f.default)
        for f in dataclasses.fields(cls)
    }


JAX_CLASSES = _dataclasses(jax_config)


def test_same_dataclasses():
    assert set(_dataclasses(torch_config)) == set(JAX_CLASSES)


@pytest.mark.parametrize("name", sorted(JAX_CLASSES))
def test_dataclass_fields_and_defaults(name):
    ours = getattr(torch_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(JAX_CLASSES[name])
    ]
    assert _defaults(ours) == _defaults(JAX_CLASSES[name])


PRESETS = sorted(
    name for name, fn in vars(jax_presets).items()
    if inspect.isfunction(fn) and fn.__module__ == jax_presets.__name__
    and not name.startswith("_")
)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match(name):
    assert _norm(getattr(torch_presets, name)()) == _norm(getattr(jax_presets, name)())


@pytest.mark.parametrize("writer,reader", [
    (jax_config, torch_config), (torch_config, jax_config),
])
def test_config_json_round_trip(tmp_path, writer, reader):
    src = (jax_presets if writer is jax_config else torch_presets).rcnn_unittest()
    path = str(tmp_path / "cfg.json")
    writer.save_config(src, path)
    loaded = reader.load_config(path)
    assert type(loaded).__module__ == reader.__name__
    assert _norm(loaded) == _norm(src)
