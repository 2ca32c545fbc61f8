"""Paper FL experiment settings (Table II)."""
from __future__ import annotations

PAPER_TASKS = {
    'task1_regression': dict(m=5, dataset_size=506, rounds=100, epochs=3,
                             batch_size=5, lr=1e-4, t_lim=830.0, features=13),
    'task2_cnn': dict(m=100, dataset_size=70_000, rounds=50, epochs=5,
                      batch_size=40, lr=1e-3, t_lim=5600.0, features=(28, 28)),
    'task3_svm': dict(m=500, dataset_size=186_480, rounds=100, epochs=5,
                      batch_size=100, lr=1e-2, t_lim=1620.0, features=35),
}
