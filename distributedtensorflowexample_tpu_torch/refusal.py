# graftlint: stdlib-only
"""The one shape every mode-legality refusal goes through.

A copy of the JAX package's ``refusal.py``.  An illegal knob combination
— or a mode the port does not run yet — fails at flag-validation time
with a message that names the flag and says why, never a silent
fallback.  :class:`ModeRefusal` subclasses ``ValueError`` so existing
``except ValueError`` sites keep working, and ``grep -rn ModeRefusal``
enumerates the port's whole refusal surface.
"""

from __future__ import annotations


class ModeRefusal(ValueError):
    """A named refusal of an illegal mode/knob combination.

    Raise with a message that (a) names the flag(s) by their CLI
    spelling and (b) says why the combination is refused rather than
    degraded.
    """
