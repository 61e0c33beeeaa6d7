"""A run whose timed path is broken underneath comes out not correct: the
harness driven on the CPU at small sizes (the look for a card skipped),
with each fault the cell can have planted in the program. One chip has no
exchange between chips to leave out. The control, the reference in
bfloat16 in the program's place, fails the same limits."""

import time

import pytest

from benchmark import checks, control, run

from conftest import SMALL

SEED = 3_000_000_123


def small(cell):
    _, cfg, _, _ = run.cell_parts(run.load_spec(), cell)
    return SMALL[cfg["name"]]


def drive(cell):
    return run.run_cell(run.load_spec(), cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                        small(cell))


TRAIN = ["train_vanilla_7k", "train_refine_highpoly"]
SERVE = ["serve_refined_highpoly", "serve_refined_highpoly_near"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    line = drive(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def _unchanged(monkeypatch, cell):
    """A step that returns its state unchanged."""
    if cell == "train_vanilla_7k":
        import sugar_tpu_torch.trainers.vanilla as mod

        real = mod.make_train_step

        def make(*a, **k):
            step = real(*a, **k)

            def broken(params, alive, adam, stats, *rest):
                _, _, _, aux = step(params, alive, adam, stats, *rest)
                return params, adam, stats, aux

            return broken

        monkeypatch.setattr(mod, "make_train_step", make)
    else:
        import sugar_tpu_torch.refine.trainer as mod

        real = mod.make_refine_step

        def make(*a, **k):
            step = real(*a, **k)

            def broken(params, adam, *rest):
                _, _, aux = step(params, adam, *rest)
                return params, adam, aux

            return broken

        monkeypatch.setattr(mod, "make_refine_step", make)


def _half_batch(monkeypatch, cell):
    """Half of the batch left out, the mean taken over the rest: the loss
    over the top half of the image's rows."""
    import sugar_tpu_torch.utils.losses as mod

    real = mod.rgb_loss_l1_dssim

    def half(pred, target, *a, **k):
        h = pred.shape[0] // 2
        return real(pred[:h], target[:h], *a, **k)

    monkeypatch.setattr(mod, "rgb_loss_l1_dssim", half)


def _altered(monkeypatch, cell):
    """An answer altered where it is produced: one tile of every served
    image turned white."""
    import sugar_tpu_torch.models.render as mod

    real = mod.render_model

    def altered(*a, **k):
        out = real(*a, **k)
        img = out["image"].clone()
        img[:16, :16] = 1.0
        return dict(out, image=img)

    monkeypatch.setattr(mod, "render_model", altered)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in (_unchanged, _half_batch)]
                         + [(c, _altered) for c in SERVE])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    line = drive(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_is_not_correct(cell):
    r = control.readings(cell, SEED, "cpu", small(cell))
    ok, compared = checks.judge(r["bfloat16"], r["limits"])
    assert not ok, compared
