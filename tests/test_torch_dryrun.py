"""The port's dry run (``launch/dryrun.py``) and the spec helpers only it
reads, against the reference's: ``SHAPES``, ``shape_applicable``,
``cells()``, ``input_specs`` and ``eval_specs`` (shapes and dtypes, every
arch), ``model_size``, and ``model_flops`` exactly for every
arch x shape x tp in {1, 16}; then ``lower_cell`` gives ``ok`` records for a
train, a prefill and a decode cell of reduced configs on a small fake mesh
(a subprocess: the fake process group is process-wide), and the
reference's ``skip`` record where a shape does not apply.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import dryrun as jdry
from repro.models import params as jparams
from repro.models import transformer as jT
from repro.parallel import sharding as jshd
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdry
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tT
from repro_torch.parallel import sharding as tshd

ROOT = Path(__file__).resolve().parents[1]
ARCHS = treg.ARCH_IDS


def test_arch_ids_shapes_and_cells_equal_the_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert treg.cells() == jreg.cells()
    assert treg.cells(["rwkv6_3b"], ["long_500k"]) == jreg.cells(["rwkv6_3b"], ["long_500k"])
    for arch in ARCHS:
        for name, shape in tbase.SHAPES.items():
            assert tbase.shape_applicable(treg.get_config(arch), shape) == \
                jbase.shape_applicable(jreg.get_config(arch), jbase.SHAPES[name])
    assert treg.all_configs() == {a: treg.get_config(a) for a in ARCHS}
    assert [c.name for c in treg.all_configs().values()] == \
        [c.name for c in jreg.all_configs().values()]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """The meta batch of each train and prefill shape: keys, shapes and
    dtypes the reference's ``ShapeDtypeStruct``s have; no storage."""
    for name, shape in tbase.SHAPES.items():
        if shape.kind == "decode":
            continue
        got = treg.input_specs(treg.get_config(arch), shape)
        want = jreg.input_specs(jreg.get_config(arch), jbase.SHAPES[name])
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape)
            assert str(v.dtype).removeprefix("torch.") == np.dtype(want[k].dtype).name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [1, 16])
def test_eval_specs_equal_the_reference(arch, tp):
    """``eval_specs`` of the padded config's parameters (as they are, and in
    bf16) and of a decode cache: the reference's shapes and dtypes, leaf by
    leaf in its order, on ``meta``."""
    tcfg = tbase.pad_for_tp(treg.get_config(arch), tp)
    jcfg = jbase.pad_for_tp(jreg.get_config(arch), tp)
    pairs = [(tT.model_param_specs(tcfg, tp=tp), jT.model_param_specs(jcfg, tp=tp)),
             (tT.cache_specs(tcfg, 4, 64, tp=tp), jT.cache_specs(jcfg, 4, 64, tp=tp))]
    for tspecs, jspecs in pairs:
        for dt, jdt in ((None, None), (torch.bfloat16, jax.numpy.bfloat16)):
            got = tparams.tree_leaves(tparams.eval_specs(tspecs, dt))
            want = jax.tree.leaves(jparams.eval_specs(jspecs, jdt))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape)
                assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name


class _Axes:
    def __init__(self, shape):
        self.shape, self.axis_names = shape, tuple(shape)


@pytest.mark.parametrize("shape", [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
                                   {"data": 4}, {"model": 8}])
def test_model_size_equals_the_reference(shape):
    mesh = _Axes(shape)
    assert tshd.model_size(mesh) == jshd.model_size(mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equals_the_reference(arch):
    for name, shape in tbase.SHAPES.items():
        for tp in (1, 16):
            assert tdry.model_flops(treg.get_config(arch), shape, tp=tp) == \
                jdry.model_flops(jreg.get_config(arch), jbase.SHAPES[name], tp=tp), (name, tp)


CELLS = [("granite_3_2b", "train_4k", False), ("deepseek_moe_16b", "prefill_32k", True),
         ("minicpm3_4b", "decode_32k", False), ("rwkv6_3b", "long_500k", True),
         ("granite_3_2b", "long_500k", False)]


@pytest.fixture(scope="module")
def records():
    """``lower_cell`` of each cell in ``CELLS`` with the arch's reduced
    config (``smoke()``'s fields as overrides) on a fake 8-rank group: a
    (data 4, model 2) mesh for the pod, (pod 2, data 2, model 2) for the
    multi-pod."""
    code = textwrap.dedent(f"""
        import dataclasses, json
        from repro_torch.configs.registry import get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh

        def small(multi_pod):
            D.fake_world(8)
            if multi_pod:
                return make_mesh((2, 2, 2), ("pod", "data", "model"))
            return make_mesh((4, 2), ("data", "model"))

        D.production_mesh = small
        out = []
        for arch, shape, mp in {CELLS!r}:
            smoke = get_config(arch).smoke()
            ov = {{f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}}
            out.append(D.lower_cell(arch, shape, multi_pod=mp, cfg_overrides=ov))
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "accounting", "t_lower_s",
        "flops_per_device", "bytes_per_device", "collectives", "peak_live_bytes_analytic",
        "fits_hbm_analytic", "model_flops_per_device", "useful_flops_ratio", "terms",
        "dominant", "roofline_fraction", "op_count", "bytes_hlo_walk"}


@pytest.mark.parametrize("i", range(len(CELLS) - 1), ids=[f"{a}-{s}" for a, s, _ in CELLS[:-1]])
def test_lower_cell_gives_ok_records(records, i):
    """Each applicable cell: ``ok``, the reference's keys (less those with no
    meaning here), positive counts, collectives over the model axis (the
    mesh's axes only) and the terms' dominant one named."""
    rec = records[i]
    arch, shape, mp = CELLS[i]
    assert rec["status"] == "ok" and set(rec) == KEYS
    assert (rec["arch"], rec["shape"], rec["multi_pod"], rec["n_chips"]) == (arch, shape, mp, 8)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["bytes_hlo_walk"] >= rec["bytes_per_device"]
    assert rec["peak_live_bytes_analytic"] > 0 and rec["fits_hbm_analytic"]
    coll = rec["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k in coll["per_kind_count"])
    assert coll["count"] == sum(coll["per_kind_count"].values()) > 0
    assert coll["per_axis"]["model"] > 0
    assert set(coll["per_axis"]) <= {"pod", "data", "model"}
    assert sum(coll["per_axis"].values()) == coll["total"]
    t = rec["terms"]
    assert min(t.values()) > 0 and rec["dominant"] == max(t, key=t.get)
    assert rec["roofline_fraction"] == pytest.approx(t["compute_s"] / max(t.values()))
    assert 0 < rec["useful_flops_ratio"]


def test_lower_cell_skips_as_the_reference(records):
    arch, shape, mp = CELLS[-1]
    want = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "skip",
            "reason": jbase.shape_applicable(jreg.get_config(arch), jbase.SHAPES[shape])[1]}
    assert records[-1] == want
