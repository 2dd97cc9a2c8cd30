"""The search plane: format encoding (``primitives``, ``formats``), the
sparsity model (``sparsity``), hardware and workloads (``arch``,
``workload``), dataflows (``dataflow``), candidate generation (``engine``),
the analytical cost model (``costmodel``), the progressive co-search
(``cosearch``), its comparators (``baselines``) and the memo registry
(``memo``).

Copies of the JAX package's ``repro.core`` modules, which are numpy-only:
the search gives the same plans, float for float.  None of these modules
imports ``torch``: a ``cosearch_multi`` process worker, a spawned
interpreter, imports them and touches neither torch nor the card."""
