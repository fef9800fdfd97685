from stereo_visual_slam.geom import se3  # noqa: F401
