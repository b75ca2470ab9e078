"""SUO-DAC's per-image domain labels (PyTorch port of
``boosting_rcnn_tpu/data/suodac.py``; the reference's
``LoadImageFromSUODAC``, ``mmdet/datasets/pipelines/loading.py:87``).

The underwater domain-generalisation recipe tags every image with its
water type.  ``DomainMap`` reads the domains once: a directory of name
lists (one text file a domain, in sorted file order), or a JSON file as
``{"domain name": ["stem", ...], ...}`` (domains in sorted key order) or
``{"stem": domain_id, ...}``.  An image is looked up by its file stem; an
unlisted one is domain 0, and a stem in two lists takes the first.  The
loader's ``domain_file`` gives each train image ``one_hot`` as its
``domain_label``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

__all__ = ["DomainMap"]


class DomainMap:
    """Image stem -> domain id, from ``domain_file`` (a directory of name
    lists or a JSON file in either layout)."""

    def __init__(self, domain_file: str):
        self.domains: List[List[str]] = []
        if os.path.isdir(domain_file):
            for name in sorted(os.listdir(domain_file)):
                with open(os.path.join(domain_file, name)) as f:
                    self.domains.append([ln.strip() for ln in f if ln.strip()])
        else:
            with open(domain_file) as f:
                mapping = json.load(f)
            if mapping and all(isinstance(v, (list, tuple)) for v in mapping.values()):
                for key in sorted(mapping):
                    self.domains.append([str(s) for s in mapping[key]])
            else:
                n = int(max(mapping.values())) + 1 if mapping else 0
                self.domains = [[] for _ in range(n)]
                for stem, d in mapping.items():
                    self.domains[int(d)].append(str(stem))
        self._index: Dict[str, int] = {}
        for i, names in enumerate(self.domains):
            for n in names:
                self._index.setdefault(n, i)

    @property
    def num_domains(self) -> int:
        return len(self.domains)

    def domain_of(self, path: str) -> int:
        """The domain of the image at ``path``, by its stem (0 when unlisted)."""
        stem = os.path.basename(path).rsplit(".", 1)[0]
        return self._index.get(stem, 0)

    def one_hot(self, path: str) -> np.ndarray:
        """``(num_domains,)`` float32, 1 at the image's domain."""
        v = np.zeros((self.num_domains,), np.float32)
        v[self.domain_of(path)] = 1.0
        return v
