"""APM008 known-bad fixture (the port's form): torch.cuda's stream,
event, graph and device-setter APIs and library loading outside the
device plane — every shape the rule must catch."""
import ctypes

import torch
from torch.cuda import CUDAGraph  # import form


def order(dev):
    side = torch.cuda.Stream(dev)          # streams
    with torch.cuda.stream(side):
        pass
    torch.cuda.current_stream(dev).wait_stream(side)
    return torch.cuda.Event()              # events


def capture(fn):
    g = torch.cuda.CUDAGraph()             # graphs
    with torch.cuda.graph(g):
        fn()
    return g, CUDAGraph


def choose(dev):
    torch.cuda.set_device(dev)             # device setters
    torch.cuda.synchronize(dev)


def load(path):
    return ctypes.CDLL(path), torch.ops.load_library(path)  # loading
