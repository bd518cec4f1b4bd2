"""Log loaders and the synthetic log simulator (numpy only).

`load_carmen_log` parses with the native C++ parser (data/native.py) when
it builds, else with the Python one (data/carmen.py), as the JAX
package's slam2d_tpu/data/__init__.py does; `load_carmen_log.last_parser`
says which ran last ("native" or "python").
"""

from slam2d_tpu_torch.data.carmen import (  # noqa: F401
    carmen_to_json,
    load_json_log,
    save_carmen_log,
    save_json_log,
)
from slam2d_tpu_torch.data.carmen import load_carmen_log as _load_carmen_py
from slam2d_tpu_torch.data.synth import SynthWorld, simulate_log  # noqa: F401


def load_carmen_log(path: str):
    """CARMEN loader: native C++ parser when built, Python fallback."""
    from slam2d_tpu_torch.data import native

    if native.native_available():
        load_carmen_log.last_parser = "native"
        return native.load_carmen_log_native(path)
    load_carmen_log.last_parser = "python"
    return _load_carmen_py(path)


load_carmen_log.last_parser = None
