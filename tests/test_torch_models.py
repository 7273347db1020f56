"""The model registry in the port against the JAX package's: the same
names, the same parameter counts, weight bytes, load seconds and canvas
geometry for every spec (``efficientnet_b7``'s from the conv net's
``count_params``), and reduced ``vit_s16`` / ``efficientnet_b7`` builds
whose ``serve_fn`` outputs, given the JAX build's weights through
``detector.convert_params``, match the JAX build's within 1e-4 (float32)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import EfficientNetConfig as JEfficientNetConfig
from repro.configs import efficientnet_b7 as jeff_b7
from repro.configs import vit_s16 as jvit_s16
from repro.core import models as jmodels
from repro.models import efficientnet as jeff
from repro_torch import configs
from repro_torch.config import DetectorConfig, EfficientNetConfig
from repro_torch.configs import efficientnet_b7, vit_s16
from repro_torch.core import models as tmodels
from repro_torch.models import detector as tdet
from repro_torch.models import efficientnet as teff


def zoo_names(models_module):
    """The names a registry seeds from the configs zoo, read from a fresh
    registry: other tests in the process may have registered their own
    specs in the shared one, which is restored afterwards."""
    saved, seeded = dict(models_module._MODELS), models_module._seeded
    models_module._MODELS.clear()
    models_module._seeded = False
    try:
        return models_module.model_names()
    finally:
        models_module._MODELS.clear()
        models_module._MODELS.update(saved)
        models_module._seeded = seeded


def test_registry_names_equal_jax():
    """The JAX registry's names, and the port's own ``vitdet_l`` (a trunk
    the JAX package does not have)."""
    assert zoo_names(jmodels) == (
        "efficientnet_b7", "tangram", "tangram_int8", "vit_s16",
        "vit_s16_int8")
    assert zoo_names(tmodels) == zoo_names(jmodels) + ("vitdet_l",)
    assert set(zoo_names(tmodels)) <= set(tmodels.model_names())


@pytest.mark.parametrize("name", ["efficientnet_b7", "tangram",
                                  "tangram_int8", "vit_s16",
                                  "vit_s16_int8"])
def test_spec_economics_equal_jax(name):
    j, t = jmodels.make_model(name), tmodels.make_model(name)
    assert (t.canvas_m, t.canvas_n, t.weight_bytes, t.load_s, t.dtype) == \
        (j.canvas_m, j.canvas_n, j.weight_bytes, j.load_s, j.dtype)
    assert t.arch.n_params == j.arch.n_params
    # the JAX config's fields; the port's ViTDet fields at their defaults
    shared = [f.name for f in dataclasses.fields(DetectorConfig)
              if hasattr(j.arch, f.name)]
    assert {k: getattr(t.arch, k) for k in shared} == \
        {k: getattr(j.arch, k) for k in shared}
    assert t.arch.plain
    assert t.reduced_arch(128) == DetectorConfig(**{
        f.name: getattr(j.reduced_arch(128), f.name)
        for f in dataclasses.fields(DetectorConfig)
        if hasattr(j.reduced_arch(128), f.name)})


@pytest.mark.parametrize("width,depth,res", [(2.0, 3.1, 600),
                                             (1.0, 1.0, 224),
                                             (1.4, 1.8, 380)])
def test_efficientnet_specs_equal_jax(width, depth, res):
    """``block_args``, every spec's shape and dtype name, and
    ``count_params`` equal the JAX package's (B7, B0 and B4 scalings)."""
    j = JEfficientNetConfig(name="e", img_res=res, width_mult=width,
                            depth_mult=depth)
    t = EfficientNetConfig(name="e", img_res=res, width_mult=width,
                           depth_mult=depth)
    assert teff.block_args(t) == jeff.block_args(j)
    jspecs = jax.tree_util.tree_leaves_with_path(
        jeff.param_specs(j), is_leaf=lambda x: hasattr(x, "shape"))
    tflat = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tflat.append((path, node))
    walk(teff.param_specs(t), ())
    assert len(tflat) == len(jspecs)
    tmap = {path: s for path, s in tflat}
    for path, js in jspecs:
        key = tuple(p.key for p in path)
        ts = tmap[key]
        assert ts.shape == tuple(js.shape), key
        assert str(ts.dtype).split(".")[-1] == np.dtype(js.dtype).name
        assert ts.init == js.init, key
    assert teff.count_params(t) == jeff.count_params(j)


def test_arch_configs_equal_jax():
    assert configs.get("vit-s16") == vit_s16.ARCH
    assert configs.get("efficientnet-b7") == efficientnet_b7.ARCH
    assert teff.count_params(efficientnet_b7.ARCH) == \
        jeff.count_params(jeff_b7.ARCH) == 66_585_480
    for f in ("img_res", "patch", "n_layers", "d_model", "n_heads", "d_ff"):
        assert getattr(vit_s16.ARCH, f) == getattr(jvit_s16.ARCH, f)
    from repro_torch.models import transformer
    with pytest.raises(NotImplementedError, match="item 17"):
        transformer.init_params(configs.get("mistral-large-123b"),
                                torch.Generator(), "cpu")


@pytest.mark.parametrize("name", ["vit_s16", "efficientnet_b7",
                                  "vit_s16_int8"])
def test_reduced_build_serves_like_jax(name):
    """The reduced build at canvas 128 (the JAX registry's), the JAX
    weights converted: objectness and boxes within 1e-4 on random
    canvases; the port's own build has the same structure."""
    jcfg, jparams, jserve_fn, _ = jmodels.make_model(name).build(canvas=128)
    tcfg = DetectorConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(DetectorConfig)
                             if hasattr(jcfg, f.name)})
    tparams = tdet.convert_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, torch.device("cpu"))
    x = np.random.default_rng(0).random((2, 128, 128, 3), np.float32)
    want = [np.asarray(a) for a in jserve_fn(jparams, x)]
    got = [a.numpy() for a in tdet.serve_fn(tcfg)(tparams,
                                                   torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    own_cfg, own_params, _ = tmodels.make_model(name).build(
        canvas=128, device="cpu")
    assert own_cfg == tcfg
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own_params)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            tparams))
