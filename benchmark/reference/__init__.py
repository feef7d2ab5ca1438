"""The plain float32 reference of the benchmark's configurations: the net
(``mulresunet``) and the first steps of a solve (``steps``). It imports torch
alone, nothing of the program under test."""
