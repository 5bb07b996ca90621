"""The plain reference: block-sparse C = A @ B in plain numpy and PyTorch.

It imports nothing of the port.  It works the product's block structure out
from the operands' coordinates (:func:`~bench.reference.blocksparse.product_tasks`),
multiplies the benchmark's own input values in float64, or in a lower
precision for the control (:func:`~bench.reference.blocksparse.product`), and
judges a result by :func:`~bench.reference.compare.compare`.
"""
