"""The dry-run's per-device count against the reference's, and the size-1
mesh axis.

A mesh axis of one device shards nothing: ``sharding.to_placements`` gives
``Replicate()`` there, so a 1x1 mesh lays every leaf out whole (torch 2.11
refused to flatten hymba's SSD decode state while its (batch, heads) dims
were ``Shard`` on two one-device axes).

Then the reduced moe, hybrid, ssm and encdec train cells lower at 1x1 and
2x2 in both packages, each arch in a subprocess of its own (the reference's
module sets ``XLA_FLAGS`` to 512 host devices before jax starts, which a
worker that already started jax would lose; the eight run side by side).
The cells run at (batch 8, seq 32): a train shape registered for the test
in each child, because the reference compiles each cell and the port's
fake step at the assigned (256, 4,096) takes minutes for the xLSTM; the
layers are unrolled in both (``scan_layers=False``: XLA counts a scanned
body once) but the reference's encdec, which scans its layers whatever
``scan_layers`` says (``src/repro/models/encdec.py:93``, ``:117``,
``:171``): its whisper counts one encoder and one decoder layer, where the
port's runs both of the reduced config's.  Raw F is not compared (XLA's cost analysis and
``FlopCounterMode`` count differently); F × N ÷ F(1x1) is, with the wire
bytes by kind.  Where the two differ, the gap is logged in ROADMAP Queue 3
with both numbers, and ``LOGGED`` below holds them: a change to either
package's layout moves a number here first.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m", "whisper-tiny")

_CHILD = """
import dataclasses, json, sys
pkg, arch = sys.argv[1], sys.argv[2]
if pkg == "repro":
    from repro.launch import dryrun     # first: XLA_FLAGS before jax starts
    from repro.configs import get_config, get_reduced
    from repro.configs.shapes import ShapeSpec
else:
    from repro_torch.launch import dryrun
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.shapes import ShapeSpec
dryrun.SHAPES["train_s32"] = ShapeSpec("train_s32", 32, 8, "train")
full, red = get_config(arch), get_reduced(arch)
ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
      if getattr(red, f.name) != getattr(full, f.name)}
ov.pop("max_seq_len", None)     # the cell's own, as _prepare_cfg sets it
ov["scan_layers"] = False
out = {}
for mesh in ("1x1", "2x2"):
    rep = dryrun.lower_cell(arch, "train_s32", mesh, overrides=ov,
                            probe=False)[0]
    out[mesh] = {"flops": rep.flops, "n": rep.num_devices,
                 "wire": rep.wire_bytes_by_kind}
print(json.dumps(out))
"""

#: F x N / F(1x1) and the 2x2 wire MB a device by kind, port beside the
#: reference (ROADMAP Queue 3): XLA repeats ~4-14% of the work, where the
#: port's count is at or near 1 (the MoE routes each group's tokens on the
#: devices that hold them, the sLSTM runs each device's channels and its
#: post-FFN on each device's columns, the SSD recurrence each device's own
#: run of chunks); the
#: kinds differ in form (the port reduce-scatters the ZeRO-1 grads and the
#: MoE's buffers, XLA all-reduces and permutes; the SSD's exchange of chunk
#: summaries is all-to-all, which at (8, 32) outweighs the gathers it
#: saves: its bytes do not shrink with the sequence)
LOGGED = {
    "qwen2-moe-a2.7b": (
        1.0000, 1.1411,
        {"all-gather": 0.7030, "all-reduce": 0.0040, "all-to-all": 0.1147,
         "reduce-scatter": 0.6601},
        {"all-gather": 0.6369, "all-reduce": 1.5799, "all-to-all": 0.1659,
         "collective-permute": 0.0515}),
    "hymba-1.5b": (
        1.0000, 1.0829,
        {"all-gather": 0.8070, "all-reduce": 0.0041, "all-to-all": 0.2320,
         "reduce-scatter": 1.0384},
        {"all-gather": 0.5392, "all-reduce": 1.9172, "all-to-all": 0.1932,
         "collective-permute": 0.0510}),
    "xlstm-125m": (
        1.0000, 1.0666,
        {"all-gather": 0.3064, "all-reduce": 0.1441, "all-to-all": 1.0058,
         "reduce-scatter": 0.1959},
        {"all-gather": 0.4845, "all-reduce": 0.8777, "all-to-all": 1.2872,
         "collective-permute": 2.0134}),
    "whisper-tiny": (
        1.0000, 1.0591,
        {"all-gather": 0.5038, "all-reduce": 0.0070, "all-to-all": 0.0655,
         "reduce-scatter": 0.5033},
        {"all-gather": 0.4398, "all-reduce": 1.0154, "all-to-all": 0.1175,
         "collective-permute": 0.0617}),
}


@pytest.mark.parametrize("dims", [(1, 1), (2, 1), (1, 4), (2, 2)])
def test_a_one_device_axis_replicates(dims):
    m = mesh_mod.make_abstract_mesh(dims, ("data", "model"))
    got = sh.to_placements(("data", "model", None), m)
    assert got == tuple(Shard(d) if n > 1 else Replicate()
                        for d, n in enumerate(dims))
    assert sh.to_placements(((None,)), m) == (Replicate(), Replicate())


def test_hymba_decode_lays_out_whole_and_lowers_at_1x1():
    cfg = get_reduced("hymba-1.5b").replace(max_seq_len=64)
    shape = dryrun.SHAPES["decode_32k"]
    with mesh_mod.fake_mesh((1, 1), ("data", "model")) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh, shape)):
            fm = dryrun._fake_mode()
            with fm:
                params = specs.abstract_params(cfg)
                cache = specs.abstract_cache(cfg, params, shape)
                laid = specs.attach(
                    cache, specs.cache_logical_specs(cfg, cache), mesh)
            leaves = [x for x in tree_leaves(laid)
                      if hasattr(x, "placements")]
            assert leaves and all(
                p == Replicate() for x in leaves for p in x.placements)
    full, red = get_config("hymba-1.5b"), get_reduced("hymba-1.5b")
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
          if getattr(red, f.name) != getattr(full, f.name)}
    rep, low = dryrun.lower_cell("hymba-1.5b", "decode_32k", "1x1",
                                 overrides=ov, probe=False)
    assert rep.flops > 0 and low.wire_bytes == 0.0


@pytest.fixture(scope="module")
def lowered():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {(pkg, arch): subprocess.Popen(
        [sys.executable, "-c", _CHILD, pkg, arch], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("repro", "repro_torch") for arch in ARCHS}
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, f"{key}: {stderr[-3000:]}"
            out[key] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ratio(cells):
    one, two = cells["1x1"], cells["2x2"]
    assert (one["n"], two["n"]) == (1, 4)
    assert not any(one["wire"].values())
    return two["flops"] * two["n"] / one["flops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_flops_and_wire_stand_beside_the_references(arch,
                                                                lowered):
    port, ref = lowered[("repro_torch", arch)], lowered[("repro", arch)]
    port_ratio, ref_ratio, port_wire, ref_wire = LOGGED[arch]
    assert _ratio(port) == pytest.approx(port_ratio, abs=1e-4)
    assert _ratio(ref) == pytest.approx(ref_ratio, abs=1e-4)
    for got, want in ((port, port_wire), (ref, ref_wire)):
        mb = {k: v / 1e6 for k, v in got["2x2"]["wire"].items() if v}
        assert mb == pytest.approx(want, abs=1e-4)
