"""The port's dry-run cells (``repro_torch.launch.specs.build_cell``) hold
the reference's arguments leaf by leaf: for every applicable cell on both
production meshes, each leaf's path, global shape, dtype and partition
spec, and the cell's mode, ``accum`` and ``donate``.

The reference builds its cells on 512 forced host devices without
compiling them; the port's stand over a fake process group.  Both run in a
child process, so neither the forced devices nor the fake group leak into
the rest of the test run.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CODE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import jax
import torch
torch.set_num_threads(1)
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.launch.mesh import make_production_mesh as ref_mesh
from repro.launch.specs import build_cell as ref_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell, leaf_layouts


def norm(part):
    if part is None or isinstance(part, str):
        return part
    part = tuple(part)
    return part[0] if len(part) == 1 else list(part)


def ref_layouts(args):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]:
        spec = tuple(leaf.sharding.spec) if leaf.sharding is not None else ()
        spec += (None,) * (len(leaf.shape) - len(spec))
        out.append([jax.tree_util.keystr(path), list(leaf.shape),
                    str(leaf.dtype), [norm(p) for p in spec]])
    return out


multi = json.loads(sys.argv[1])
jmesh, tmesh = ref_mesh(multi_pod=multi), make_production_mesh(multi_pod=multi)
report = {"cells": [], "leaves": 0, "mismatches": []}
for arch in ARCH_IDS:
    for shape in SHAPES:
        if not shape_applicable(get_config(arch), SHAPES[shape])[0]:
            continue
        r, p = ref_cell(arch, shape, jmesh), build_cell(arch, shape, tmesh)
        want = ref_layouts(r.args)
        got = [[path, list(s), str(d).split(".")[-1], [norm(x) for x in sp]]
               for path, s, d, sp in leaf_layouts(p.args)]
        report["cells"].append(p.name)
        report["leaves"] += len(want)
        meta = [(r.mode, r.accum, list(r.donate)),
                (p.mode, p.accum, list(p.donate))]
        if meta[0] != meta[1]:
            report["mismatches"].append([p.name, "meta", meta])
        if len(want) != len(got):
            report["mismatches"].append([p.name, "leaves", len(want),
                                         len(got)])
        for w, g in zip(want, got):
            if w != g:
                report["mismatches"].append([p.name, w, g])
print(json.dumps(report))
"""


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_every_cell_holds_the_references_arguments(multi_pod):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(CODE),
         json.dumps(multi_pod)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(report["cells"]) == 33     # 40 cells less long_500k x 7
    assert report["leaves"] > 33 * 10
    assert report["mismatches"] == [], report["mismatches"][:10]
