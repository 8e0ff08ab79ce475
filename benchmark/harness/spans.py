"""The kernel entries' arguments, kept while a stretch is profiled so
that each launch's operations and bytes can be counted after it.  The
layers' host times come from the program's own spans
(``benchmark/harness/program_trace.py``)."""


class KernelArgs:
    """Keeps each call's arguments of the named functions of a module
    (the kernel entries of ``kernels/``) while attached."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = {n: [] for n in names}
        self._saved = {}

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.module, n)
            self._saved[n] = fn

            def wrapped(*a, _fn=fn, _n=n, **kw):
                self.calls[_n].append(a)
                return _fn(*a, **kw)

            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.module, n, fn)
