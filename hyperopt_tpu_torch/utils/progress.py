"""Progress reporting for the fmin loop.

Counterpart of ``hyperopt_tpu/utils/progress.py``: a tqdm bar with a
``best loss:`` postfix, and a no-op variant.  tqdm is optional; without it progress reporting is a silent no-op.
"""

from __future__ import annotations

import contextlib
import sys

try:
    from tqdm import tqdm as _tqdm
except Exception:  # pragma: no cover - tqdm is normally present
    _tqdm = None


class _ProgressHandle:
    def update(self, n):
        raise NotImplementedError

    def postfix(self, best_loss):
        raise NotImplementedError


class _TqdmHandle(_ProgressHandle):
    def __init__(self, bar):
        self.bar = bar

    def update(self, n):
        if n > 0:
            self.bar.update(n)

    def postfix(self, best_loss):
        self.bar.set_postfix_str(f"best loss: {best_loss:.6g}")


class _NullHandle(_ProgressHandle):
    def update(self, n):
        pass

    def postfix(self, best_loss):
        pass


class _TqdmRedirectFile:
    """File-like that routes writes through ``tqdm.write`` so objective
    prints land above the bar instead of mangling it."""

    def __init__(self, file):
        self._file = file

    def write(self, x):
        if x.rstrip():
            _tqdm.write(x.rstrip(), file=self._file)

    def flush(self):
        getattr(self._file, "flush", lambda: None)()

    def isatty(self):
        return getattr(self._file, "isatty", lambda: False)()


@contextlib.contextmanager
def std_out_err_redirect_tqdm():
    """Redirect stdout/stderr through ``tqdm.write`` for the duration."""
    orig_out, orig_err = sys.stdout, sys.stderr
    try:
        sys.stdout = _TqdmRedirectFile(orig_out)
        sys.stderr = _TqdmRedirectFile(orig_err)
        yield orig_err
    finally:
        sys.stdout, sys.stderr = orig_out, orig_err


@contextlib.contextmanager
def default_callback(initial=0, total=None):
    """tqdm progress context.

    While the bar is live, stdout/stderr route through ``tqdm.write`` so
    prints from the user's objective don't tear the bar line.
    """
    if _tqdm is None:
        yield _NullHandle()
        return
    with std_out_err_redirect_tqdm() as real_err:
        with _tqdm(initial=initial, total=total, file=real_err,
                   dynamic_ncols=True,
                   disable=not real_err.isatty()) as bar:
            yield _TqdmHandle(bar)


@contextlib.contextmanager
def no_progress_callback(initial=0, total=None):
    """Silent progress context."""
    yield _NullHandle()
