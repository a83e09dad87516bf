"""Input: the synthetic box-world sequence (rendered in torch, in memory
or written as a KITTI-layout directory, with the procedural or a photo
texture), the KITTI-layout dataset reader, the native decoder and
prefetch ring, the PNG codec, Pillow's bilinear resize, the FPGA-style
test patterns and the synthetic 9-DoF IMU."""
