"""Plain PyTorch/NumPy reference of the DSVT detector, its training loss and
AdamW, at float32 (TF32 off).

A frozen copy of the detector's semantics: voxelize, the PFN VFE, the
window and rotated-set partitions, 4 blocks x 2 set-attention encoders,
the BEV scatter, the BEV ResNet, the CenterHead, top-k decode and greedy
rotated NMS; the CenterPoint loss and AdamW for training.  It imports
nothing of ``jax``, ``dsvt_ai_trt_tpu`` or ``dsvt_ai_trt_tpu_torch``, and
works out everything again from the seeded inputs and the raw checkpoint.
``quant`` (``Precision``) rounds the operands of every product, which is
how the control computes the same model at a lower precision.
"""
