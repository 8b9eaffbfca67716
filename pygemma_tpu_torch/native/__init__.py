"""Native (C++) host IO, built with g++ at first use and loaded via ctypes."""
