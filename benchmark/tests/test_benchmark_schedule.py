"""The open-loop schedule: the same for the same seed; for another seed the
same gaps and query sizes in another order (every seed offers the same
work)."""

import numpy as np
import pytest

from harness import cells

drv = cells.driver("open_loop_adapt_predict")
TRAFFIC = cells.part("traffic", "adapt_predict_over_knee")


def test_same_seed_same_schedule():
    a = drv.schedule(TRAFFIC, 2147483659, 20.0)
    b = drv.schedule(TRAFFIC, 2147483659, 20.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_other_seed_same_work_in_another_order():
    (ta, qa), (tb, qb) = drv.schedule(TRAFFIC, 2147483659, 20.0), drv.schedule(TRAFFIC, 3000000019, 20.0)
    assert not np.array_equal(ta, tb) and not np.array_equal(qa, qb)
    # n - 1 of the same n gaps lie between the sends
    assert len(np.intersect1d(np.round(np.diff(ta), 12), np.round(np.diff(tb), 12))) >= len(ta) - 2
    assert sorted(qa.tolist()) == sorted(qb.tolist())
    assert len(ta) == round(TRAFFIC["rate_per_s"] * 20.0)


@pytest.mark.parametrize("seconds", [5.0, 20.0])
def test_sizes_follow_the_weights_and_arrivals_fill_the_window(seconds):
    times, sizes = drv.schedule(TRAFFIC, 7, seconds)
    n = len(sizes)
    for q, w in zip(TRAFFIC["query_sizes"], TRAFFIC["query_weights"]):
        assert abs((sizes == q).sum() - w * n) <= 1
    assert times[0] == 0.0 and np.all(np.diff(times) > 0) and times[-1] < seconds


def test_requests_are_fresh_and_seeded():
    cfg = cells.part("configs", "omniglot20w5s-vgg64")["maml"]
    a = drv.request(cfg, 5, 0, 3, 15, 0.3)
    b = drv.request(cfg, 5, 0, 3, 15, 0.3)
    c = drv.request(cfg, 5, 0, 4, 15, 0.3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (20, 5, 28, 28, 1) and a[2].shape == (15, 28, 28, 1)
