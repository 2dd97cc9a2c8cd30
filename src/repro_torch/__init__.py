"""PyTorch/CUDA port of the execution plane (compressed serving).

Imports ``torch`` and numpy only — never ``jax`` and nothing of the JAX
package ``repro``, which stays in the repository as the reference the port
is tested against.  Every entry point takes ``device=`` and defaults to
``"cuda"``; the CPU runs only when the caller passes ``"cpu"``, and then
every hand-written kernel is replaced by its plain PyTorch version.
"""
