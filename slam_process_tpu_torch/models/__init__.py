"""The port's estimators.  ``run_estimator`` (``models/registry.py``) is
exported lazily, so that importing this package loads no estimator module
(and neither pandas nor matplotlib, which the port never imports at module
level)."""


def __getattr__(name):
    if name == "run_estimator":
        from slam_process_tpu_torch.models.registry import run_estimator

        return run_estimator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
