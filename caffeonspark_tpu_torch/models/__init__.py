from .zoo import alexnet, caffenet, lenet  # noqa: F401
