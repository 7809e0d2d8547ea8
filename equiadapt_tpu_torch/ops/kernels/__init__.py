"""Hand-written CUDA kernels with their plain PyTorch versions.

`select_warp`: the steered rotate-select (K1) and the fused
rotate-select-roll (K2), from `csrc/select_warp.cu`.
`shear_rotate`: the centered quarter turn (K5) and the three-shear residual
(K6), from `csrc/shear_rotate.cu`.
`bilinear_warp`: the exact bilinear rotation warp (K7), from
`csrc/bilinear_warp.cu`.
`knn`: the fused k-nearest-neighbour indices (K8), from `csrc/knn.cu`.
`orbit`: the exact D4 orbit (K4), from `csrc/orbit.cu`, and
`materialize_orbit`, the |G|-orbit of the orbit-scoring paths.
`sam_attention`: SAM's attention with its decomposed relative-position
bias in one kernel, from `csrc/sam_attention.cu` (no TPU counterpart: the
JAX package writes it out).
`spectral_conv`: a stride-1 convolution as two real FFTs around a channel
contraction bin by bin, the contraction from `csrc/spectral_conv.cu` (no
TPU counterpart: the JAX package's convolution is XLA's).
`roi_align`: Mask R-CNN's multi-scale RoIAlign, every region and level in
one launch, from `csrc/roi_align.cu`; `nms`: greedy NMS of many segments
(an IoU bitmask, then a scan a segment) on the device, from `csrc/nms.cu`
(no TPU counterpart: the JAX package pools no regions and suppresses
nothing).
`bn_act`: a ResNet's eval BatchNorm, residual add and ReLU in one pass
over channels-last activations, from `csrc/bn_act.cu` (no TPU counterpart:
XLA fuses them into the JAX package's convolutions).
"""
