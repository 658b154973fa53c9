"""Tests of the benchmark run the program on the CPU at tiny sizes; a few
threads each keep their windows long enough when several run at once."""

import torch

torch.set_num_threads(2)
