"""Error enforcement helpers (counterpart of paddle_tpu/core/enforce.py):
the PADDLE_ENFORCE family as typed Python errors."""


class EnforceNotMet(RuntimeError):
    pass


class InvalidArgumentError(ValueError):
    pass


class NotFoundError(KeyError):
    pass


class UnimplementedError(NotImplementedError):
    pass


class OutOfRangeError(IndexError):
    pass


def enforce(cond, msg="", exc=EnforceNotMet):
    if not cond:
        raise exc(msg)


def enforce_eq(a, b, msg=""):
    if a != b:
        raise InvalidArgumentError(f"{msg} (expected {a!r} == {b!r})")


def enforce_gt(a, b, msg=""):
    if not a > b:
        raise InvalidArgumentError(f"{msg} (expected {a!r} > {b!r})")


def enforce_shape_match(s1, s2, msg=""):
    if tuple(s1) != tuple(s2):
        raise InvalidArgumentError(f"{msg} (shape {tuple(s1)} vs {tuple(s2)})")
