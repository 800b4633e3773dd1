"""The work each request kind needs, by kernel family, from the HE operations
and their shapes (never from the launches a program makes): the bytes that
each stage of one family reads and writes once, keys and tables once a
request, and the integer instructions of the transforms and products."""
