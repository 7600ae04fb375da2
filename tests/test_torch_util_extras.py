"""The port's ``utils/disk_queue.DiskBasedQueue`` and
``utils/moving_window.MovingWindowMatrix`` against the JAX package's, on
the CPU: the cases of ``tests/test_util_extras.py`` (the moving-window
text and the inverted index are in ``tests/test_torch_text_tools.py``),
the windows bit-equal to JAX's, the queue's FIFO order, spill files and
a threaded producer/consumer run."""

import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.utils.moving_window import (  # noqa: E402
    MovingWindowMatrix as JMovingWindowMatrix,
)
from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue  # noqa: E402
from deeplearning4j_tpu_torch.utils.moving_window import (  # noqa: E402
    MovingWindowMatrix,
)


def test_moving_window_matrix_chunks():
    m = np.arange(24).reshape(4, 6)
    wins = MovingWindowMatrix(m, 2, 3).windows()
    assert len(wins) == 4
    np.testing.assert_array_equal(wins[0], [[0, 1, 2], [3, 4, 5]])
    np.testing.assert_array_equal(wins[-1], [[18, 19, 20], [21, 22, 23]])


def test_moving_window_matrix_flattened_and_rotate():
    m = np.arange(8)
    flat = MovingWindowMatrix(m, 2, 2).windows(flattened=True)
    assert len(flat) == 2 and flat[0].shape == (4,)
    rot = MovingWindowMatrix(m, 2, 2, add_rotate=True).windows()
    assert len(rot) == 8
    np.testing.assert_array_equal(rot[3], [[0, 1], [2, 3]])


@pytest.mark.parametrize("shape,rows,cols", [((4, 6), 2, 3), ((5, 5), 2, 2),
                                             ((3, 8), 3, 1), ((10,), 2, 2)])
@pytest.mark.parametrize("flattened", [False, True])
@pytest.mark.parametrize("rotate", [False, True])
def test_windows_equal_jax(shape, rows, cols, flattened, rotate):
    m = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = MovingWindowMatrix(m, rows, cols, add_rotate=rotate).windows(
        flattened=flattened)
    want = JMovingWindowMatrix(m, rows, cols, add_rotate=rotate).windows(
        flattened=flattened)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_disk_queue_fifo(tmp_path):
    q = DiskBasedQueue(str(tmp_path))
    assert q.is_empty() and q.poll() is None and q.peek() is None
    q.add({"a": 1})
    q.put(np.arange(3))
    assert len(q) == 2
    assert len(list(tmp_path.glob("*.pkl"))) == 2
    assert q.peek() == {"a": 1}
    assert q.poll() == {"a": 1}
    np.testing.assert_array_equal(q.poll(), np.arange(3))
    assert q.poll() is None
    q.add(1)
    q.clear()
    assert q.is_empty()
    assert not list(tmp_path.glob("*.pkl"))


def test_disk_queue_default_directory():
    q = DiskBasedQueue()
    q.add("x")
    assert q._dir.exists() and q.poll() == "x"


def test_disk_queue_threads_lose_nothing(tmp_path):
    q = DiskBasedQueue(str(tmp_path))
    n_prod, per = 8, 50
    got, lock = [], threading.Lock()
    done = threading.Event()

    def produce(k):
        for i in range(per):
            q.add((k, i))

    def consume():
        while not (done.is_set() and q.is_empty()):
            item = q.poll()
            if item is not None:
                with lock:
                    got.append(item)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        cons = [threading.Thread(target=consume) for _ in range(4)]
        prods = [threading.Thread(target=produce, args=(k,))
                 for k in range(n_prod)]
        for t in cons + prods:
            t.start()
        for t in prods:
            t.join(timeout=60)
        done.set()
        for t in cons:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in cons + prods)
    finally:
        sys.setswitchinterval(old)
    assert sorted(got) == sorted((k, i) for k in range(n_prod)
                                 for i in range(per))
    for k in range(n_prod):  # each producer's items in its FIFO order
        mine = [i for kk, i in got if kk == k]
        assert len(mine) == per
    assert not list(tmp_path.glob("*.pkl"))
