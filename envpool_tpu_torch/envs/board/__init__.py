"""Board-game env family (pgx-class), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/board``: the board, card and dice games
of the reference's pgx family, with integer state equal to the JAX
package's bit for bit.
"""

from .animal_shogi import AnimalShogiEnv
from .backgammon import BackgammonEnv
from .chess import ChessEnv
from .game_2048 import Game2048Env
from .gardner_chess import GardnerChessEnv
from .go import GoEnv
from .hex import HexEnv
from .leduc import LeducHoldemEnv
from .othello import OthelloEnv
from .poker import KuhnPokerEnv
from .shogi import ShogiEnv
from .sparrow_mahjong import SparrowMahjongEnv
from .turn_games import Connect4Env, TicTacToeEnv

__all__ = [
    "AnimalShogiEnv",
    "BackgammonEnv",
    "ChessEnv",
    "Connect4Env",
    "Game2048Env",
    "GardnerChessEnv",
    "GoEnv",
    "HexEnv",
    "KuhnPokerEnv",
    "LeducHoldemEnv",
    "OthelloEnv",
    "ShogiEnv",
    "SparrowMahjongEnv",
    "TicTacToeEnv",
]
