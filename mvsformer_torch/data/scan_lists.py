"""The benchmark test lists: the part of `mvsformer_tpu/data/scan_lists.py`
that `python -m mvsformer_torch.test` reads when no `--testlist` is given."""

DTU_TEST = [
    'scan1',
    'scan4',
    'scan9',
    'scan10',
    'scan11',
    'scan12',
    'scan13',
    'scan15',
    'scan23',
    'scan24',
    'scan29',
    'scan32',
    'scan33',
    'scan34',
    'scan48',
    'scan49',
    'scan62',
    'scan75',
    'scan77',
    'scan110',
    'scan114',
    'scan118',
]

TT_INTERMEDIATE = [
    'Family',
    'Horse',
    'Francis',
    'M60',
    'Panther',
    'Playground',
    'Train',
    'Lighthouse',
]

TT_ADVANCED = [
    'Palace',
    'Auditorium',
    'Ballroom',
    'Courtroom',
    'Museum',
    'Temple',
]
