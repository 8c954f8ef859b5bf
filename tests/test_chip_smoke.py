"""chip_smoke.py at a tiny size on the CPU: the same phase bodies the card
runs, the refusal to run anywhere but a GPU, and the exact result line."""

import json

import jax
import numpy as np
import pytest

import chip_smoke


def _cpu(_=None):
    return jax.devices()[0]


def test_refuses_a_cpu_device(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_phases_pass_and_last_line_is_the_result(capsys):
    rc = chip_smoke.main([], require_device=_cpu, sizes=chip_smoke.TINY)
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, "\n".join(out)
    phases = [ln for ln in out if ln.startswith("phase ")]
    assert len(phases) == 3 and all(": PASS " in ln for ln in phases)
    assert out[-2].startswith("card: ")
    assert out[-1] == json.dumps({"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": len(jax.devices())}})


def test_four_cards_phase_only(capsys):
    rc = chip_smoke.main(["--four-cards"], require_device=_cpu,
                         sizes=chip_smoke.TINY)
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, "\n".join(out)
    phases = [ln for ln in out if ln.startswith("phase ")]
    assert len(phases) == 1 and phases[0].startswith("phase four_cards: PASS")
    assert json.loads(out[-1])["ok"] is True


def test_synthetic_grads_match_host_replay():
    n, dim = 300, 32
    dev = np.asarray(chip_smoke.synthetic_grads(n, dim, 17))
    pos = np.arange(17, 17 + n, dtype=np.uint32)
    host = chip_smoke._grad_q(np, pos, np.arange(dim, dtype=np.uint32))
    np.testing.assert_array_equal(dev, host * chip_smoke.GRAD_UNIT)
    assert set(np.unique(host)) <= set(range(-4, 5))


def _replay_case(rng):
    """One sampled key in the batch with a consistent before/after state."""
    init = rng.uniform(-0.01, 0.01, (2, chip_smoke.DIM)).astype(np.float32)
    r0 = init.copy()
    a0 = np.full(2, 0.1, np.float32)
    f0 = np.array([True, True])
    gsum = np.zeros((2, chip_smoke.DIM), np.int64)
    gsum[0] = rng.integers(-40, 40, chip_smoke.DIM)
    present = np.array([True, False])
    g = gsum[0] * chip_smoke.GRAD_UNIT
    a1 = a0.copy()
    a1[0] = 0.1 + (g * g).sum() / chip_smoke.DIM
    r1 = r0.copy()
    r1[0] = r0[0] - chip_smoke.LR / np.sqrt(a1[0] + 1e-8) * g
    return (f0, r0, a0), (f0.copy(), r1, a1), r0.copy(), present, gsum, init


def test_replay_check_accepts_the_rule_and_catches_faults(rng):
    before, after, out, present, gsum, init = _replay_case(rng)
    stats = chip_smoke._replay_check(before, after, out, present, gsum, init, 0.1)
    assert stats["live"] == 1 and stats["row_err"] <= chip_smoke.ROW_RTOL
    f1, r1, a1 = after
    bad = r1.copy()
    bad[0, 3] += 1e-4  # a wrong update
    with pytest.raises(AssertionError):
        chip_smoke._replay_check(before, (f1, bad, a1), out, present, gsum,
                                 init, 0.1)
    bad = r1.copy()
    bad[1, 0] = np.nextafter(bad[1, 0], 1)  # an untouched row moved one ulp
    with pytest.raises(AssertionError):
        chip_smoke._replay_check(before, (f1, bad, a1), out, present, gsum,
                                 init, 0.1)
    with pytest.raises(AssertionError):  # forward row not the stored row
        chip_smoke._replay_check(before, after, out + 1e-7, present, gsum,
                                 init, 0.1)


@pytest.mark.gpu
def test_card_filling_step_aliases_values_plane(gpu):
    """At 2^28 slots the donated 32 GiB values plane is updated in place."""
    sz = chip_smoke.FULL
    spec = chip_smoke.table_spec(sz.big_cap)
    _, ma = chip_smoke.compile_table_step(spec, sz.batch // 2, sz.batch,
                                          sz.sample)
    info = chip_smoke.check_aliasing(spec, ma, sz)
    assert info["plane_GiB"] == 32.0
