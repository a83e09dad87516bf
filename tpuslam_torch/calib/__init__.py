"""Stereo calibration toolbox (stereo_calib tool twin): the counterpart
of tpuslam/calib/, with the same exports."""

from .calibrate import (board_points, calibrate_camera, stereo_calibrate,
                        stereo_rectify)
from .chessboard import find_chessboard, project_points, render_chessboard
from .yaml_io import (q_matrix, read_opencv_yaml, write_camera_info_yaml,
                      write_opencv_yaml)

__all__ = [
    "board_points", "calibrate_camera", "stereo_calibrate",
    "stereo_rectify", "find_chessboard", "project_points",
    "render_chessboard", "q_matrix", "read_opencv_yaml",
    "write_camera_info_yaml", "write_opencv_yaml",
]
