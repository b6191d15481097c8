"""The benchmark's plain float32 reference: the YOLO11 segment network
(yolo.py) and its post-processing (post.py). Imports torch and numpy
only, never the program under test."""
