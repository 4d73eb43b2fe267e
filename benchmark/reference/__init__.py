"""Plain PyTorch reference of the outer training step that the benchmark
times: the body model, the camera, the soft silhouette, the two-stage
refinement, the prior and regressor updates and the evaluations, written
from the method's description (ubc-vision/joint-regressor-refinement,
scripts/optimize.py:148-337) in float32 with plain tensor operations.

It imports nothing of the port, of JAX or of the JAX package, and takes
only the inputs the benchmark makes: the body arrays, the batches, the
initial regressor and prior weights.
"""
