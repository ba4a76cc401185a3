"""Tensor ops: boxes, anchors, NMS, kNN, image crops, RANSAC (+ the
CUDA kernels for hard NMS and fused kNN)."""
