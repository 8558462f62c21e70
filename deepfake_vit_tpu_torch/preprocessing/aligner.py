"""Alignment template: the normalized 5-point reference landmarks."""

DEFAULT_REFERENCE_LANDMARKS = {
    "left_eye": (0.31, 0.32),
    "right_eye": (0.69, 0.32),
    "nose": (0.50, 0.55),
    "left_mouth": (0.35, 0.75),
    "right_mouth": (0.65, 0.75),
}
_LANDMARK_ORDER = ("left_eye", "right_eye", "nose", "left_mouth", "right_mouth")
