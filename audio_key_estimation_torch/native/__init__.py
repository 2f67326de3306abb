"""The port's host C++ audio library and its ctypes binding."""
