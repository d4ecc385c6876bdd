"""The host-read guard of the port's step tests: a step under
``no_host_reads`` raises ``HostRead`` at any read of a tensor's value on
the host outside ``ops/graph.py::run_if``'s plain version.  It imports
torch and the port only (the gloo rank jobs of ``tests/torch_ranks.py``
use it too)."""

import contextlib

import torch

from mcmh_localization_tpu_torch.ops import graph as tgraph


class HostRead(AssertionError):
    """A step read a tensor's value on the host."""


_READS = ("__bool__", "__int__", "__index__", "__float__", "item", "tolist",
          "cpu", "numpy")


def _host_index(index) -> bool:
    """An index that PyTorch reads on the host: a 0-d integer tensor (a
    select at its value) or a bool mask (its nonzero count)."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor)
               and (i.dtype == torch.bool
                    or (i.dim() == 0 and not i.is_floating_point()))
               for i in parts)


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Make every read of a tensor's value on the host raise ``HostRead``,
    except inside ``run_if``'s plain version (``_host_predicate``, the
    gates' host ``if``): ``__bool__``, ``__int__``, ``__index__``,
    ``__float__``, ``item``, ``tolist``, ``cpu``, ``numpy``, indexing with
    a 0-d integer tensor or a bool mask, and ``nonzero``."""
    allowed = [0]

    def guard(name, fn):
        def wrapped(self, *args, **kwargs):
            if not allowed[0]:
                raise HostRead(f"Tensor.{name} in the step")
            return fn(self, *args, **kwargs)
        return wrapped

    def guard_index(name, fn):
        def wrapped(self, index, *args):
            if not allowed[0] and _host_index(index):
                raise HostRead(f"Tensor.{name} with a host-read index")
            return fn(self, index, *args)
        return wrapped

    with monkeypatch.context() as m:
        for name in _READS + ("nonzero",):
            m.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor,
                                                                name)))
        for name in ("__getitem__", "__setitem__"):
            m.setattr(torch.Tensor, name,
                      guard_index(name, getattr(torch.Tensor, name)))
        plain = tgraph._host_predicate

        def predicate(pred):
            allowed[0] += 1
            try:
                return plain(pred)
            finally:
                allowed[0] -= 1

        m.setattr(tgraph, "_host_predicate", predicate)
        yield
