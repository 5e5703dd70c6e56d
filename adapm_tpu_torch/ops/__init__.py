"""Hot-path device programs: the hand-written kernels (kernels.py) and the
device-routed fused step (fused.py)."""


def __getattr__(name):
    # lazy: the device plane imports ops.kernels, and fused.py imports
    # the store, which imports the device plane
    if name in ("DeviceRoutedRunner", "DeviceRouter",
                "make_device_routed_step"):
        from . import fused
        return getattr(fused, name)
    raise AttributeError(name)
