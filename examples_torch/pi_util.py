"""Sibling module for the pi job — the reference's cross-module-import
demo (jobs-client/user_program/resources/util.py:1-3). Counterpart of
``examples/pi_util.py``."""


def inside(x, y):
    return x * x + y * y <= 1.0
