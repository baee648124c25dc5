"""ImageNet-style image classification (reference:
example/image-classification)."""
