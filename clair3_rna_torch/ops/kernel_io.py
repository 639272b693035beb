"""What every kernel wrapper of the port shares: the count of its kernel's
launches and the checks on the tensors it hands to a kernel."""

import threading

# one lock for every counter: the calling pipeline launches kernels from its
# two prefetch threads
_lock = threading.Lock()


def launch_counter(*names):
    """(launches, reset_launches, count_launch) for one module's wrappers.

    `launches` maps each wrapper's name to the launches of its kernel;
    count_launch(name) is called only where the CUDA kernel is launched, so
    a run can show that its main path went through the kernel."""
    launches = dict.fromkeys(names, 0)

    def reset_launches():
        with _lock:
            for k in launches:
                launches[k] = 0

    def count_launch(name):
        with _lock:
            launches[name] += 1

    return launches, reset_launches, count_launch


def check(name, t, dtype, shape):
    """Raise unless tensor `t` has `dtype`, `shape` and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def one_device(kernel, tensors):
    """The one device all `tensors` lie on: a CPU device (the wrapper runs
    its plain version) or a CUDA device (it launches the kernel). Raises on
    mixed devices and on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel} inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} kernel: unsupported device {dev}")
    return dev
