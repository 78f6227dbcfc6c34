"""Plain references: each template's answer worked out again in numpy from
the tables the benchmark generated. They import only the standard library,
numpy, pandas and pyarrow, and take nothing the program has made.

Each module has ``prepare(tables) -> state`` (once per run, from the
generated columns) and ``answer(state, params, dtype) -> {column: array}``;
``dtype`` is the precision every float is computed in (float64 as the
configuration states; float32 for the control)."""
