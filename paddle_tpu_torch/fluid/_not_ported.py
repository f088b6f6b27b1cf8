"""The error of a name that ``paddle_tpu.fluid`` has and the port has
not yet."""


class NotPortedError(NotImplementedError, AttributeError):
    """Raised by the ``fluid`` modules' ``__getattr__`` for a name of the
    JAX package's ``fluid`` that the port lacks; the message names its
    ``ROADMAP.md`` queue. It is an ``AttributeError`` too, so ``hasattr``
    reads False."""


def not_ported(module: str, name: str, queue: str) -> NotPortedError:
    return NotPortedError(f"{module}.{name} is not ported yet "
                          f"(ROADMAP.md {queue})")
