"""The port's ``scripts.run_parity`` against the JAX package's
``scripts/run_parity.py`` on the CPU.

The JAX script runs in this process through ``runpy`` (its
compilation-cache settings are dropped, so it leaves the JAX
configuration as it found it). Both scripts' scene and pipeline
configurations are captured for ``--small`` and the full run and held
equal; then both run the whole protocol at a toy size (the port's
``CONFIGS["small"]`` shrunk, the JAX script given the same scene and
``parity_config``) and each stage's held-out scores are held to the JAX
script's:

- vanilla PSNR within 1e-3 dB and SSIM within 1e-4 (measured: 1e-6 dB);
- coarse-SDF PSNR within 1e-2 dB and SSIM within 1e-3 (measured: 9e-4 dB,
  1.8e-4; the SDF samples' rounding differs);
- the decimated mesh's vertex and face counts within 1% (measured: 498
  against 499 vertices: QEM's order of equal costs);
- refined PSNR within 0.1 dB and SSIM within 0.02 (measured: 0.017 dB,
  0.007), since the refinement then binds Gaussians to another mesh and
  is scored on one 32x32 image.
"""

import json
import os
import runpy
import sys
import types

import jax
import numpy as np
import pytest
import torch

import sugar_tpu.eval.parity as jparity
import sugar_tpu.pipeline as jpipe
from sugar_tpu_torch.scripts import run_parity

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Three coarse iterations: the prune the protocol schedules at 30% of the
# coarse window then falls on its first iteration, which the trainer does
# not run, so the toy model keeps its Gaussians. 33 iterations leave every
# opacity under the protocol's 0.5 prune, hence 0.05.
TOY = (dict(n_gt=600, n_init=300, n_cams=8, resolution=32), (30, 3, 6), 1024,
       dict(total_points=20_000, poisson_resolution=32, decimation_target=500,
            dup_capacity=2**13, prune_opacity_threshold=0.05))


class Stop(Exception):
    pass


def run_jax_parity(argv, monkeypatch):
    """scripts/run_parity.py as ``python scripts/run_parity.py argv``
    would run it, without its compilation-cache settings."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if "cache" in k else update(k, v))
    monkeypatch.setattr(sys, "argv", ["run_parity.py"] + list(argv))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "run_parity.py"), run_name="__main__")
    finally:
        monkeypatch.setattr(jax.config, "update", update)


@pytest.mark.parametrize("small", [True, False])
def test_run_parity_configs_match_the_jax_script(tmp_path, monkeypatch, small):
    """The scene each script asks for and the PipelineConfig it runs, up
    to the stage overrides' render_mode, which the port adds ("tiled" on
    the CPU, the JAX trainers' "auto" there)."""
    fake_scene = types.SimpleNamespace(split=lambda eval_split: (list(range(7)), [7]),
                                       cameras=[None] * 8)
    got = {}

    def scene(who):
        def make(**kw):
            got[who + "_scene"] = kw
            return fake_scene, None
        return make

    def jax_config(**kw):
        got["jax_cfg"] = kw
        raise Stop

    def port_vanilla(cfg, *args, **kw):
        got["port_cfg"] = cfg
        raise Stop

    argv = ["--small"] * small + ["--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "o")]
    monkeypatch.setattr(jparity, "make_parity_scene", scene("jax"))
    monkeypatch.setattr(jpipe, "PipelineConfig", jax_config)
    with pytest.raises(Stop):
        run_jax_parity(argv, monkeypatch)
    monkeypatch.setattr(run_parity, "make_parity_scene", scene("port"))
    monkeypatch.setattr(run_parity, "run_vanilla", port_vanilla)
    with pytest.raises(Stop):
        run_parity.main(argv, device="cpu")

    assert got["port_scene"].pop("device") == "cpu"
    assert got["port_scene"] == got["jax_scene"]
    assert got["jax_scene"]["render_mode"] == "tiled"
    cfg, want = got["port_cfg"], got["jax_cfg"]
    for stage in ("vanilla_overrides", "coarse_overrides", "refine_overrides"):
        assert getattr(cfg, stage).pop("render_mode") == "tiled"
    for field, value in want.items():
        assert getattr(cfg, field) == value, field
    assert sorted(want) != [] and want["output_dir"] == str(tmp_path / "w")


def test_run_parity_toy(tmp_path, monkeypatch, capsys):
    """The protocol end to end at a toy size in both packages, on the CPU
    ("tiled", as both scripts choose off the card): four stages, the
    results JSON, every stage's scores against the JAX script's."""
    monkeypatch.setitem(run_parity.CONFIGS, "small", TOY)
    out = str(tmp_path / "parity.json")
    res = run_parity.main(["--small", "--out", out, "--workdir", str(tmp_path / "w")],
                          device="cpu")
    assert "mode=tiled" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)["stages"] == res["stages"]
    assert set(res["stages"]) == {"vanilla", "coarse_sdf", "mesh", "refined"}
    for stage in ("vanilla", "coarse_sdf", "refined"):
        assert np.isfinite(res["stages"][stage]["psnr"]) and res["stages"][stage]["psnr"] > 5.0
    assert res["stages"]["mesh"]["faces"] > 0

    # The JAX script on the same toy scene and configuration.
    make_scene, config = jparity.make_parity_scene, jpipe.PipelineConfig
    monkeypatch.setattr(jparity, "make_parity_scene", lambda **kw: make_scene(**(kw | TOY[0])))

    def toy_config(**kw):
        cfg = run_parity.parity_config(kw["output_dir"], *TOY[1:])
        return config(**{f: getattr(cfg, f) for f in config.__dataclass_fields__})

    monkeypatch.setattr(jpipe, "PipelineConfig", toy_config)
    jout = str(tmp_path / "jax.json")
    run_jax_parity(["--small", "--out", jout, "--workdir", str(tmp_path / "jw")], monkeypatch)
    assert "mode=tiled" in capsys.readouterr().out
    with open(jout) as f:
        want = json.load(f)["stages"]
    got = res["stages"]
    assert set(want) == set(got)
    for stage, db, ssim in (("vanilla", 1e-3, 1e-4), ("coarse_sdf", 1e-2, 1e-3),
                            ("refined", 0.1, 0.02)):
        assert got[stage]["n_images"] == want[stage]["n_images"] == 1
        assert abs(got[stage]["psnr"] - want[stage]["psnr"]) <= db, (stage, got, want)
        assert abs(got[stage]["ssim"] - want[stage]["ssim"]) <= ssim, (stage, got, want)
    for k in ("vertices", "faces"):
        assert abs(got["mesh"][k] - want["mesh"][k]) <= 0.01 * want["mesh"][k], (got, want)
