"""Write no bytecode from a process that has ``src`` on its path.

Python imports ``sitecustomize`` at start-up from the first ``sys.path`` entry
that holds one, so every ``PYTHONPATH=src`` process reads this file, the JAX
package's processes as much as the port's: also a child started with an
environment of its own that leaves out ``PYTHONDONTWRITEBYTECODE`` (as
``tests/test_moe_a2a.py``'s does).  Stale ``__pycache__`` dirs under ``src/``
shadow source edits, and ``tests/test_hygiene.py`` fails on them.  Python
caches this module's own bytecode before its first line runs, so it removes
that file and its dir again; a check that walks ``src/`` in that instant can
still see them.  A ``sitecustomize`` further down the path, which this file
shadows, is run after it.

This is a stop-gap: it can go once every test that starts a child with an
environment of its own passes ``PYTHONDONTWRITEBYTECODE=1`` to it.
"""

import importlib.machinery
import importlib.util
import os
import sys

sys.dont_write_bytecode = True
if __cached__:
    try:
        os.remove(__cached__)
        os.rmdir(os.path.dirname(__cached__))
    except OSError:
        pass

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    __name__, [p for p in sys.path if os.path.abspath(p or os.curdir) != _here])
if _spec is not None and _spec.loader is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
