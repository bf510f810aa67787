"""File resolver (counterpart of ``core/fresolver.py``, the reference's
src/core/fresolver.cpp): ordered search paths for scene-relative
assets."""
from __future__ import annotations

import os
from typing import List


class FileResolver:
    def __init__(self):
        self.paths: List[str] = [os.getcwd()]

    def append(self, path: str):
        self.paths.append(path)

    def prepend(self, path: str):
        self.paths.insert(0, path)

    def resolve(self, name: str) -> str:
        """The first search path under which ``name`` exists, joined to
        it; ``name`` unchanged where none holds it."""
        if os.path.isabs(name) and os.path.exists(name):
            return name
        for p in self.paths:
            cand = os.path.join(p, name)
            if os.path.exists(cand):
                return cand
        return name

    def __contains__(self, path: str):
        return path in self.paths


_resolver = FileResolver()


def file_resolver() -> FileResolver:
    """mi.file_resolver(): the process's resolver."""
    return _resolver
