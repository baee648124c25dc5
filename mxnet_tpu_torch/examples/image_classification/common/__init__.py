"""The shared data loaders and training driver of the image-classification
examples (reference: example/image-classification/common)."""
