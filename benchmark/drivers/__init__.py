"""One module per way of driving the program: tick (the XR loop) and
stream (batched frames through StreamingRunner). A cell's file names its
driver."""
