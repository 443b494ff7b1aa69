"""The paper's aggregation pipeline (OBCSAA, simulation mode) in PyTorch.

Import the modules themselves (``repro_torch.core.obcsaa``, ...): this
package imports nothing, so ``repro_torch.decode`` can use
``core.sparsify`` without a cycle through ``core.obcsaa``."""
