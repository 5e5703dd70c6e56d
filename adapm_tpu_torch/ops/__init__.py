"""Hot-path device programs: the hand-written kernels (kernels.py) and the
fused training steps (fused.py)."""


def __getattr__(name):
    # lazy: the device plane imports ops.kernels, and fused.py imports
    # the store, which imports the device plane
    if name in ("DeviceRoutedRunner", "DeviceRouter", "FusedStepRunner",
                "build_routes", "make_device_routed_step",
                "make_fused_adagrad_step"):
        from . import fused
        return getattr(fused, name)
    raise AttributeError(name)
