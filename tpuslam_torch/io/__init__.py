"""Input: the synthetic box-world sequence (rendered in torch, in memory
or written as a KITTI-layout directory), the KITTI-layout dataset reader,
the native decoder and prefetch ring, the PNG codec and Pillow's bilinear
resize."""
