"""The port's logical-axis sharding (``repro_torch/parallel/sharding.py``,
``models/params.py::logical_axes``, ``configs/base.py::pad_for_tp``)
against the JAX reference's own functions.

``spec_for`` reads only a mesh's ``axis_names`` and ``shape``, so both
packages run on a stand-in mesh (no devices): (data 2, model 4), the
production (data 16, model 16) and (pod 2, data 16, model 16).  Every leaf
of every config's parameter specs (padded for the mesh's model axis, as the
train step pads them) and of its AdamW state specs (int8 compression on, so
the error tree is covered too) gets the same spec from both packages under
every rule set: train, prefill and decode, "tp" and "fsdp", with and
without sequence parallelism, and a config with ``fsdp`` set.  Then
``block`` and ``gather`` on the host mesh, and what ``make_production_mesh``
says without its ranks.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import pad_for_tp as jpad_for_tp
from repro.models import transformer as jT
from repro.models.params import logical_axes as jlogical_axes
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro_torch.configs import registry as treg
from repro_torch.configs.base import pad_for_tp
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tT
from repro_torch.models.params import logical_axes, tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as shd

MESHES = {"2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULE_SETS = [(phase, mode, sp) for phase in ("train", "prefill", "decode")
             for mode in ("tp", "fsdp") for sp in (False, True)]


class _StandIn:
    """What ``spec_for`` reads of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jleaves(tree):
    import jax

    return jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))


def _specs(arch, tp):
    """(reference, port) parameter and AdamW state spec leaves of ``arch``
    padded for ``tp``."""
    jcfg, tcfg = jpad_for_tp(jreg.get_config(arch), tp), pad_for_tp(treg.get_config(arch), tp)
    jp = jT.model_param_specs(jcfg, tp=tp)
    tp_ = tT.model_param_specs(tcfg, tp=tp)
    jo = jadamw.state_specs(jp, jadamw.AdamWConfig(state_dtype=jnp.float32, compress_int8=True))
    to = tadamw.state_specs(tp_, tadamw.AdamWConfig(compress_int8=True))
    return jcfg, _jleaves(jp) + _jleaves(jo), tree_leaves(tp_) + tree_leaves(to)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_spec_for_and_rules_for_match_the_reference(arch, mesh_name):
    mesh = _StandIn(MESHES[mesh_name])
    jcfg, jl, tl = _specs(arch, mesh.shape["model"])
    assert [(s.shape, s.axes) for s in jl] == [(s.shape, s.axes) for s in tl]
    for fsdp in (False, True):
        cfg = dataclasses.replace(jcfg, fsdp=fsdp)
        for phase, mode, sp in RULE_SETS:
            want_rules = jshd.rules_for(cfg, phase, seq_parallel=sp, sharding_mode=mode)
            rules = shd.rules_for(cfg, phase, seq_parallel=sp, sharding_mode=mode)
            assert rules == want_rules, (phase, mode, sp, fsdp)
            for js, ts in zip(jl, tl):
                want = tuple(jshd.spec_for(js.axes, want_rules, mesh, js.shape))
                assert shd.spec_for(ts.axes, rules, mesh, ts.shape) == want, \
                    (phase, mode, sp, fsdp, ts.shape, ts.axes)
                assert shd.spec_for(ts.axes, rules, mesh) == \
                    tuple(jshd.spec_for(js.axes, want_rules, mesh))
    assert shd.dp_axes(mesh) == jshd.dp_axes(mesh)


def _dict_leaves(tree) -> list:
    """The values of a nested dict, keys sorted (``jax.tree.leaves`` would
    flatten the axis tuples themselves)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _dict_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_logical_axes_and_pad_for_tp_match_the_reference(arch):
    for tp in (1, 2, 4, 16):
        jcfg = jpad_for_tp(jreg.get_config(arch), tp)
        tcfg = pad_for_tp(treg.get_config(arch), tp)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), tp
        got = tree_leaves(logical_axes(tT.model_param_specs(tcfg, tp=tp)))
        assert got == _dict_leaves(jlogical_axes(jT.model_param_specs(jcfg, tp=tp))), tp


def test_sharding_trees_drop_nondivisible_axes():
    """``tests/test_multidevice.py``'s three asserts, on the port's
    ``spec_for``."""
    mesh = _StandIn({"data": 2, "model": 4})
    rules = shd.rules_for(type("C", (), {"fsdp": False})(), "train")
    assert shd.spec_for(("batch", "seq"), rules, mesh, (1, 64)) == ()
    assert shd.spec_for(("embed", "heads", "head_dim"), rules, mesh, (8, 6, 4)) == ()
    assert shd.spec_for(("embed", "heads", "head_dim"), rules, mesh, (8, 8, 4)) == \
        (None, "model")


def test_block_and_gather_on_the_host_mesh_are_the_tensor():
    mesh = make_host_mesh()
    x = torch.arange(24.0).reshape(4, 6)
    for spec in ((), ("model",), (("data", "model"), None), (None, "data")):
        assert shd.block(x, spec, mesh) is x
        assert shd.gather(x, spec, mesh) is x
    assert mesh.size == 1 and mesh.psum(x, "model") is x


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs a process group of 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs a process group of 512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        Mesh({"data": 2, "model": 1})
