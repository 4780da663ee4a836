"""From-scratch reimplementations of the paper's four baselines (§2.2).

The port of ``repro.core.baselines``: host numpy over the port's
``geometry`` and ``pruning``, carried over unchanged.  All share the STR
R-tree substrate (``rtree.py``) the way the paper's baselines share
R*-trees; the parity tests hold their masks and counters against the
JAX package's.
"""

from repro_torch.core.baselines.infzone import infzone_rknn
from repro_torch.core.baselines.rtree import STRTree
from repro_torch.core.baselines.six import six_rknn
from repro_torch.core.baselines.slice import slice_rknn
from repro_torch.core.baselines.tpl import tpl_rknn

__all__ = ["STRTree", "six_rknn", "tpl_rknn", "infzone_rknn", "slice_rknn"]
