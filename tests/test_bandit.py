"""UCB1-tuned bandit + CompactTuner (negative_feedback.hpp:20-260)."""

import numpy as np

from ccve.control.bandit import CompactTuner, MultiArmedBandit


def test_warm_start_round_robin():
    b = MultiArmedBandit(3)
    picks = [b.select_arm() for _ in range(3 * MultiArmedBandit.START_SAMPLING)]
    assert picks == [0, 1, 2] * MultiArmedBandit.START_SAMPLING


def test_converges_to_best_arm():
    rng = np.random.default_rng(0)
    b = MultiArmedBandit(4)
    true_means = [0.2, 0.5, 0.9, 0.4]
    picks = []
    for _ in range(2000):
        arm = b.select_arm()
        picks.append(arm)
        b.update_arm(arm, true_means[arm] + rng.normal(0, 0.05))
    # after warm-up, the best arm dominates
    tail = picks[-500:]
    assert tail.count(2) > 350


def test_ew_update_factor_cap():
    b = MultiArmedBandit(1)
    for _ in range(100):
        b.select_arm()
        b.update_arm(0, 1.0)
    # cap at 15 keeps the estimate responsive: after a regime change the
    # estimate moves by 1/16 per update at least
    b.update_arm(0, 0.0)
    assert b.est_rewards[0] <= 1.0 - 1.0 / 16 + 1e-12


def test_change_detection_resets():
    b = MultiArmedBandit(2)
    # warm up past start sampling
    for _ in range(300):
        arm = b.select_arm()
        b.update_arm(arm, 1.0)
    assert b.n_start_sampling >= 2 * b.START_SAMPLING
    # drive reward up 3x and step to the next heartbeat boundary
    detected = False
    for _ in range(600):
        arm = b.select_arm()
        b.update_arm(arm, 5.0)
        if b.n_start_sampling < 2 * b.START_SAMPLING:
            detected = True
            break
    assert detected  # reset re-entered warm start


def test_compact_tuner_maps_thresholds():
    t = CompactTuner()
    t.initialize(0, arms=(0, 64, 128))
    t.initialize(1, arms=(0, 64, 128))
    assert t.bandit_size() == 2
    assert t.get_id(0) == 0 and t.get_id(7) == -1
    thr = t.select_arm(0)
    assert thr in (0, 64, 128)
    t.update_arm(0, thr, reward=1.0)
    t.update_arm(0, 999, reward=1.0)  # unknown threshold ignored
    t.reset()
    assert t.bandit_size() == 0


def test_history_csv(tmp_path):
    b = MultiArmedBandit(2)
    for _ in range(1200):
        arm = b.select_arm()
        b.update_arm(arm, 0.5)
    p = tmp_path / "hist.csv"
    b.log_to_csv(str(p))
    lines = p.read_text().strip().splitlines()
    assert len(lines) == len(b.history) and len(lines) >= 3


def test_device_bandit_matches_host_math():
    """The on-device UCB1-tuned bandit (control/device_bandit.py) must
    track the host implementation arm-for-arm on a shared reward tape
    (f32 vs f64 rounding allowed in the estimates)."""
    import jax.numpy as jnp
    import numpy as np

    from ccve.control import device_bandit as db
    from ccve.control.bandit import MultiArmedBandit

    n_arms = 4
    rng = np.random.default_rng(11)
    means = np.array([0.2, 0.9, 0.5, 0.6])

    # reference-parity settings: the reference's warm start
    # (kStartSampling=4) and no early commit
    host = MultiArmedBandit(n_arms)
    dev = db.init_state(1, n_arms)
    for step in range(120):
        h_arm = host.select_arm()
        d_arm, dev = db.select_arms(dev, start_sampling=4)
        d_arm = int(d_arm[0])
        assert h_arm == d_arm, (step, h_arm, d_arm)
        reward = float(means[h_arm] + 0.01 * rng.standard_normal())
        host.update_arm(h_arm, reward)
        dev = db.update_arms(
            dev, jnp.asarray([h_arm], jnp.int32),
            jnp.asarray([reward], jnp.float32),
            start_sampling=4, commit_after=0,
        )
    np.testing.assert_allclose(
        np.asarray(dev.est)[0], np.asarray(host.est_rewards), rtol=2e-4
    )
    # the best arm must have been found by both
    assert int(np.asarray(dev.est)[0].argmax()) == int(
        np.argmax(host.est_rewards)
    ) == 1


def test_device_bandit_early_commit():
    """After warm start, a stable greedy arm commits within
    commit_after updates; selection then sticks to it, and a change-
    detection-scale reward shift at the heartbeat uncommits."""
    import jax.numpy as jnp
    import numpy as np

    from ccve.control import device_bandit as db

    n_arms = 3
    dev = db.init_state(1, n_arms)
    rewards = {0: 0.2, 1: 0.9, 2: 0.4}
    commit_round = None
    for step in range(60):
        arm, dev = db.select_arms(dev, start_sampling=2)
        a = int(arm[0])
        dev = db.update_arms(
            dev, jnp.asarray([a], jnp.int32),
            jnp.asarray([rewards[a]], jnp.float32),
            start_sampling=2, commit_after=4,
        )
        if commit_round is None and int(dev.committed[0]) >= 0:
            commit_round = step
    assert int(dev.committed[0]) == 1
    assert commit_round is not None and commit_round < 20
    assert int(dev.commit_t[0]) >= 0
    # once committed every select returns the committed arm
    for _ in range(5):
        arm, dev = db.select_arms(dev, start_sampling=2)
        assert int(arm[0]) == 1
