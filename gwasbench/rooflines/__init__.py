"""One module per kernel: its device function's name as torch.profiler
prints it (DEVICE_NAME, a pattern), the program function whose calls launch
it (WRAPS, "module:attribute"), and work(args, kwargs) -> (bytes, operations)
of one launch from that call's arguments, or None where the call launches
nothing.  The counts are of the computation at that shape, whatever kernel
computes it: each input and output byte once."""
