"""Native host-runtime bindings (built from source on first use; skipped if
no C++ toolchain)."""

import numpy as np
import pytest

from lio_slam_tpu.io import native


@pytest.fixture(autouse=True)
def _native_runtime():
    if not native.available():
        pytest.skip("native runtime could not be built (needs make and g++)")


class TestRingBuffer:
    def test_fifo(self):
        rb = native.RingBuffer(8, 4)
        rb.push(b"aaaaaaaa")
        rb.push(b"bbbbbbbb")
        assert len(rb) == 2
        assert rb.pop() == b"aaaaaaaa"
        assert rb.pop() == b"bbbbbbbb"
        assert rb.pop() is None

    def test_overwrite_drops_oldest(self):
        rb = native.RingBuffer(1, 4)
        for i in range(7):
            rb.push(bytes([i]))
        assert len(rb) == 4
        assert rb.pop()[0] == 3   # 0..2 dropped

    def test_bounded_reject(self):
        rb = native.RingBuffer(1, 2)
        assert rb.push(b"a", overwrite=False)
        assert rb.push(b"b", overwrite=False)
        assert not rb.push(b"c", overwrite=False)


class TestSampleQueue:
    def test_window_and_stale_pop(self):
        q = native.SampleQueue(3, capacity=128)
        for i in range(50):
            q.push(i * 0.01, np.array([i, 2 * i, 3 * i], np.float32))
        ts, vals = q.window(0.2, 0.3, margin=0.02)
        # the window keeps margin samples before t0 (deskew needs a
        # bracketing sample before scan start, imageProjection.cpp:365-369)
        assert ts[0] == pytest.approx(0.19)
        assert ts[-1] == pytest.approx(0.30)
        np.testing.assert_allclose(vals[0], [19, 38, 57])
        # samples strictly older than t0 - margin were permanently dropped
        assert len(q) == 50 - 19

    def test_overflow_compacts(self):
        q = native.SampleQueue(1, capacity=16)
        for i in range(100):
            q.push(float(i), np.array([i], np.float32))
        assert len(q) <= 16
        ts, vals = q.window(95.0, 99.0, margin=0)
        assert list(ts) == [95, 96, 97, 98, 99]


class TestHostOps:
    def test_voxel_downsample_merges(self):
        a = np.random.RandomState(0).rand(100, 3).astype(np.float32) * 0.1
        b = a + 10.0
        out = native.host_voxel_downsample(np.concatenate([a, b]), 1.0)
        assert out.shape[0] == 2

    def test_pcd_fast_path_matches_python_reader(self, tmp_path):
        from lio_slam_tpu.io import pcd as pcd_io
        xyz = np.random.RandomState(1).randn(256, 3).astype(np.float32)
        p = str(tmp_path / "fast.pcd")
        assert native.pcd_write_binary(p, xyz, np.arange(256, dtype=np.float32))
        x2, attrs = pcd_io.load_pcd(p)
        np.testing.assert_allclose(x2, xyz, atol=0)
        np.testing.assert_allclose(attrs["intensity"], np.arange(256), atol=0)
