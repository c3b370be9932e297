"""Compressed-plane combines: K3 (int8 dequantize-scale-accumulate) and K4
(masked modular sum, centered decode, common-grid dequant)."""
