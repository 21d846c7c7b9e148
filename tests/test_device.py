"""The GPU check every measurement runs first: on the CPU it refuses."""
import pytest

from mobius_rag_tpu.utils import device


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU: JAX's default device is cpu"):
        device.require_gpu()


def test_device_summary_reports_jax_view():
    s = device.device_summary()
    assert s == {"platform": "cpu", "kind": s["kind"], "count": 8}
