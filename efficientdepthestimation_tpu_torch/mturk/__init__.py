"""Amazon Mechanical Turk user-study tooling (MTurk/ in the reference):
stimulus generation, results analysis, and TUM→KinectFusion conversion.

Copies of ``efficientdepthestimation_tpu/mturk/``, host-only. pandas,
matplotlib, seaborn, jinja2, cv2, PIL and scipy are imported inside the
functions that use them.
"""
