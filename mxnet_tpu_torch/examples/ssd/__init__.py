"""SSD object detection on synthetic scenes (reference: example/ssd)."""
