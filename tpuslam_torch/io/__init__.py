"""Input: the synthetic box-world sequence (rendered in torch, in memory
or written as a KITTI-layout directory), the KITTI-layout dataset reader
and the grayscale PNG codec."""
