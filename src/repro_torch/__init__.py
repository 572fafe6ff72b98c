"""repro_torch — the One-Class Slab SVM system in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper card.

``repro_torch.fit(X, spec)`` is the training front door,
``repro_torch.fit_update(prev, X_new)`` its warm re-fit, and
``repro_torch.serve(X, spec)`` the serving one (warm-model cache + batched
scoring through the ``decision`` kernel; ``model=`` routes by name through
the registry), and ``repro_torch.serve_async`` the coroutine front door
(admission + a background driver). They run on the CUDA card unless
called with ``device="cpu"``. Imports are lazy so subpackage imports stay
cheap.
"""


def __getattr__(name):
    if name == "fit":
        from repro_torch.api import fit
        return fit
    if name == "fit_update":
        from repro_torch.api import fit_update
        return fit_update
    if name == "serve":
        # The subpackage is a callable module: ``repro_torch.serve(X, s)``
        # and ``repro_torch.serve.ModelCache`` resolve to the same object.
        import repro_torch.serve as serve_pkg
        return serve_pkg
    if name == "serve_async":
        # the coroutine front door: awaits scores through the
        # process-default admission controller + background driver
        from repro_torch.serve.async_driver import serve_async
        return serve_async
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["fit", "fit_update", "serve", "serve_async"]
